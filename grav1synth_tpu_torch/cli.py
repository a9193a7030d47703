"""Command line of the PyTorch port.

``render``, ``diff`` and ``estimate`` run on the port, on ``--device``
(default ``cuda``; without a GPU they fail rather than fall back to the
CPU). The host-only subcommands ``inspect``, ``apply``, ``generate`` and
``remove`` are the JAX package's own (they run no device code).

    python -m grav1synth_tpu_torch render in.ivf -o out.y4m [--device cuda]
    python -m grav1synth_tpu_torch diff grainy.ivf denoised.ivf -o table.txt
    python -m grav1synth_tpu_torch estimate in.ivf -o table.txt [--raw sigmas.txt]
"""

from __future__ import annotations

import argparse
import os
import sys

HOST_COMMANDS = ("inspect", "apply", "generate", "remove")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="grav1synth-torch",
        description="AV1 film grain engine on PyTorch/CUDA. Host-only "
        f"subcommands ({', '.join(HOST_COMMANDS)}) take the same arguments "
        "as grav1synth's.",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    for name in HOST_COMMANDS:
        sub.add_parser(name, help="host-only; see grav1synth " + name + " --help")
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
    from grav1synth_tpu import cli as host_cli

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in HOST_COMMANDS:
        return host_cli.main(argv)
    host_cli._setup_logging()
    args = build_parser().parse_args(argv)
    from . import pipelines

    if args.command == "estimate":
        host_cli._check_paths(args.input, args.output, args.y)
        if args.raw:
            host_cli._check_paths(args.input, args.raw, args.y)
        segments = pipelines.estimate(args.input, args.output, args.raw, device=args.device)
        print(f"Done, wrote grain table ({len(segments)} segments)")
        return 0
    if args.command == "diff":
        if os.path.abspath(args.source) == os.path.abspath(args.denoised):
            sys.exit("error: source and denoised cannot be the same file")
        if os.path.abspath(args.denoised) == os.path.abspath(args.output):
            sys.exit("error: input and output files cannot be the same")
        host_cli._check_paths(args.source, args.output, args.y)
        segments = pipelines.diff(
            args.source, args.denoised, args.output, args.filters,
            batch=args.batch, shards=args.shards, device=args.device,
        )
        print(f"Done, wrote grain table ({len(segments)} segments)")
        return 0
    host_cli._check_paths(args.input, args.output, args.y)
    n = pipelines.render(
        args.input, args.output, batch=args.batch, grain=not args.no_grain,
        shards=args.shards, device=args.device,
    )
    print(f"Done, rendered {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
