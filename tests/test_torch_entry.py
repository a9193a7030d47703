"""The port's entry points (grav1synth_tpu_torch/entry.py) on the CPU,
held to the JAX package's (__graft_entry__.py): the grain step with
tolerance 0; the multi-device dry run's planes with tolerance 0, its
frame count exactly, its energy and per-frame diff statistics within
rtol 1e-5 (the JAX package sums the energy in float32, the port in int64)
and its printed line to the JAX entry's.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from grav1synth_tpu.ops import diff_estimate as jd
from grav1synth_tpu.ops import grain_jax
from grav1synth_tpu.parallel import mesh as jax_mesh
from grav1synth_tpu_torch import entry as port_entry

from test_torch_diff import _close


def test_entry_matches_jax():
    fn, args = port_entry.entry(device="cpu")
    jfn, jargs = jax_entry.entry()
    for a, j in zip(args[:3], jargs[:3]):
        assert np.array_equal(a.numpy(), np.asarray(j))
    got = fn(*args)
    want = jfn(*jargs)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int16
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int16))
    assert not torch.equal(got[0], args[0])


def _numbers(line: str):
    m = re.search(r"(\d+) devices OK \(frames=(\d+), noise_energy=([\d.]+), diff_n_ar=(\d+)\)",
                  line)
    assert m, line
    return int(m[1]), int(m[2]), float(m[3]), float(m[4])


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_matches_jax(n, capsys):
    got = port_entry.dryrun_multichip(n, device="cpu")
    mine = capsys.readouterr().out
    jax_entry.dryrun_multichip(n)
    theirs = capsys.readouterr().out
    a, b = _numbers(mine), _numbers(theirs)
    assert a[:2] == b[:2] == (n, 2 * n)
    assert a[2] == pytest.approx(b[2], rel=1e-5) and a[3] == pytest.approx(b[3], rel=1e-5)

    # the JAX entry's step on the same inputs, outputs kept
    b_ = 2 * n
    rng = np.random.default_rng(1)
    y, cb, cr = (jnp.asarray(rng.integers(0, 256, s, dtype=np.int32))
                 for s in ((b_, 64, 64), (b_, 32, 32), (b_, 32, 32)))
    mesh = jax_mesh.make_mesh(n)
    want = jax_mesh.sharded_apply_with_stats(
        mesh, y, cb, cr, grain_jax.pack_params(jax_entry._example_params(b_)), 8
    )
    for g, w in zip(got["planes"], want[:3]):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int16))
    assert int(got["frames"]) == float(want[4]) == b_
    assert float(got["energy"]) == pytest.approx(float(want[3]), rel=1e-5)
    y2, cb2, cr2 = want[:3]
    stats = jd.mesh_pair_stats_per_frame(mesh, y2, y, cb2, cb, cr2, cr, 2, 8, 1, 1, True)
    for name, g, w in zip(("y", "cb", "cr"), got["stats"], stats):
        _close(g, {k: np.asarray(v) for k, v in w.items()}, name)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(1)
