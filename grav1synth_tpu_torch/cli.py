"""Command line of the PyTorch port.

Every subcommand runs in this package. ``inspect``, ``apply``,
``generate`` and ``remove`` are host pipelines (copies of the JAX
package's, with the same arguments and byte-identical outputs; ``--shards``
spreads IVF inputs over worker processes). ``render``, ``diff`` and
``estimate`` run on ``--device`` (default ``cuda``; without a GPU they
fail rather than fall back to the CPU).

    python -m grav1synth_tpu_torch inspect in.ivf -o table.txt [--shards N]
    python -m grav1synth_tpu_torch apply in.ivf -o out.ivf -g table.txt
    python -m grav1synth_tpu_torch generate in.ivf -o out.ivf --iso 800 --chroma
    python -m grav1synth_tpu_torch remove in.ivf -o out.ivf
    python -m grav1synth_tpu_torch render in.ivf -o out.y4m [--device cuda]
    python -m grav1synth_tpu_torch diff grainy.ivf denoised.ivf -o table.txt
    python -m grav1synth_tpu_torch estimate in.ivf -o table.txt [--raw sigmas.txt]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def _setup_logging() -> None:
    spec = os.environ.get("GRAV1_LOG", "error,grav1synth=info")
    logging.basicConfig(
        level=logging.ERROR, format="%(levelname).1s %(name)s: %(message)s"
    )
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" in item:
            name, lvl = item.split("=", 1)
            logging.getLogger(name.strip()).setLevel(lvl.strip().upper())
        else:
            logging.getLogger().setLevel(item.upper())


def _check_paths(input_path: str, output_path: str, assume_yes: bool) -> None:
    if os.path.abspath(input_path) == os.path.abspath(output_path):
        sys.exit("error: input and output files cannot be the same")
    if os.path.exists(output_path) and not assume_yes:
        if not sys.stdin.isatty():
            sys.exit(
                f"error: output file {output_path} exists (pass -y to overwrite)"
            )
        reply = input(f"Output file {output_path} exists. Overwrite? [y/N] ")
        if reply.strip().lower() not in ("y", "yes"):
            sys.exit("aborted")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="grav1synth-torch",
        description="AV1 film grain analyzer and editor, grain engine on PyTorch/CUDA",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("inspect", help="write a grain table from a video's grain headers")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True, help="grain table file to write")
    p.add_argument("-y", action="store_true", help="overwrite output without asking")
    p.add_argument(
        "--shards",
        type=int,
        default=1,
        help="parse GOP ranges in N parallel processes (IVF inputs; "
        "result is identical to --shards 1)",
    )

    p = sub.add_parser("apply", help="splice a grain table into a video")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-g", "--grain", required=True, help="grain table file to apply")
    p.add_argument("-y", action="store_true", help="overwrite output without asking")
    p.add_argument(
        "--resume",
        action="store_true",
        help="continue an interrupted IVF rewrite: with --shards, from "
        "the per-GOP work manifest (O(remaining) restart); single-"
        "process, from the last complete output packet (headers of "
        "completed packets are re-parsed to rebuild rewriter state)",
    )
    p.add_argument(
        "--shards",
        type=int,
        default=1,
        help="rewrite GOP ranges in N parallel processes (IVF inputs; "
        "output is byte-identical to --shards 1)",
    )

    p = sub.add_parser("generate", help="add photon-noise grain at a given ISO")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--iso", type=float, required=True, help="ISO setting, e.g. 400")
    p.add_argument("--chroma", action="store_true", help="generate chroma grain too")
    p.add_argument("-y", action="store_true")

    p = sub.add_parser("remove", help="strip all grain synthesis from a video")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-y", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--shards", type=int, default=1)

    p = sub.add_parser(
        "render",
        help="decode to pixels with film grain synthesized on the GPU (y4m out)",
    )
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True, help="y4m file to write")
    p.add_argument("--batch", type=int, default=16, help="frames per device batch")
    p.add_argument(
        "--no-grain", action="store_true", help="skip grain synthesis (clean decode)"
    )
    p.add_argument(
        "--shards",
        type=int,
        default=1,
        help="spread each batch's frames over this many CUDA devices, grain "
        "patterns made on each (clamped to the devices present; with --device "
        "cpu, shards run one after another on the CPU)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device for grain synthesis (default cuda; 'cpu' runs the "
        "plain PyTorch path)",
    )
    p.add_argument("-y", action="store_true")

    p = sub.add_parser(
        "diff", help="estimate a grain table from source vs denoised, on the GPU"
    )
    p.add_argument("source")
    p.add_argument("denoised")
    p.add_argument("-o", "--output", required=True, help="grain table file to write")
    p.add_argument("-y", action="store_true", help="overwrite output without asking")
    p.add_argument(
        "--filters",
        help="source preprocessing, e.g. "
        '"crop:top=42;resize:width=1920,height=1080,alg=lanczos"',
    )
    p.add_argument("--batch", type=int, default=16, help="frame pairs per device batch")
    p.add_argument(
        "--shards",
        type=int,
        default=1,
        help="spread each batch's frame pairs over this many CUDA devices "
        "(clamped to the devices present; the table does not change)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device for the statistics (default cuda; 'cpu' runs the "
        "plain PyTorch path)",
    )

    p = sub.add_parser(
        "estimate",
        help="(experimental) estimate noise from a single input, no reference, on the GPU",
    )
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True, help="grain table file to write")
    p.add_argument("-y", action="store_true", help="overwrite output without asking")
    p.add_argument("--raw", help="also write raw per-frame sigma estimates here")
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device for the statistics (default cuda; 'cpu' runs the "
        "plain PyTorch path)",
    )
    return ap


def main(argv=None) -> int:
    _setup_logging()
    args = build_parser().parse_args(argv)
    from . import pipelines

    if args.command == "inspect":
        _check_paths(args.input, args.output, args.y)
        with open(args.input, "rb") as fh:
            is_ivf = fh.read(4) == b"DKIF"
        if args.shards > 1 and is_ivf:
            from .parallel.host_shard import sharded_inspect_ivf
            from .tables import dump_table

            segments = sharded_inspect_ivf(args.input, args.shards)
            if segments is not None:
                dump_table(segments, args.output)
        else:
            if args.shards > 1:
                print("note: --shards applies to IVF inputs; using 1 shard")
            segments = pipelines.inspect(args.input, args.output)
        if segments is None:
            print("No film grain headers found")
        else:
            print(f"Done, wrote grain table ({len(segments)} segments)")
        return 0
    if args.command == "apply":
        _check_paths(args.input, args.output, args.y or args.resume)
        if args.shards > 1:
            from .parallel.host_shard import sharded_rewrite_ivf
            from .tables import load_table

            n = sharded_rewrite_ivf(
                args.input, args.output, load_table(args.grain), args.shards,
                resume=args.resume,
            )
        else:
            n = pipelines.apply_table(args.input, args.output, args.grain, resume=args.resume)
        print(f"Done, rewrote {n} video packets")
        return 0
    if args.command == "generate":
        _check_paths(args.input, args.output, args.y)
        n = pipelines.generate(args.input, args.output, args.iso, args.chroma)
        print(f"Done, rewrote {n} video packets (ISO {args.iso:g})")
        return 0
    if args.command == "remove":
        _check_paths(args.input, args.output, args.y or args.resume)
        if args.shards > 1:
            from .parallel.host_shard import sharded_rewrite_ivf

            n = sharded_rewrite_ivf(args.input, args.output, None, args.shards, resume=args.resume)
        else:
            n = pipelines.remove(args.input, args.output, resume=args.resume)
        print(f"Done, rewrote {n} video packets")
        return 0
    if args.command == "estimate":
        _check_paths(args.input, args.output, args.y)
        if args.raw:
            _check_paths(args.input, args.raw, args.y)
        segments = pipelines.estimate(args.input, args.output, args.raw, device=args.device)
        print(f"Done, wrote grain table ({len(segments)} segments)")
        return 0
    if args.command == "diff":
        if os.path.abspath(args.source) == os.path.abspath(args.denoised):
            sys.exit("error: source and denoised cannot be the same file")
        if os.path.abspath(args.denoised) == os.path.abspath(args.output):
            sys.exit("error: input and output files cannot be the same")
        _check_paths(args.source, args.output, args.y)
        segments = pipelines.diff(
            args.source, args.denoised, args.output, args.filters,
            batch=args.batch, shards=args.shards, device=args.device,
        )
        print(f"Done, wrote grain table ({len(segments)} segments)")
        return 0
    _check_paths(args.input, args.output, args.y)
    n = pipelines.render(
        args.input, args.output, batch=args.batch, grain=not args.no_grain,
        shards=args.shards, device=args.device,
    )
    print(f"Done, rendered {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
