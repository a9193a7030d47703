"""The estimate path's two kernels (``ops.estimate_kernels``) on the CPU,
where each wrapper runs its plain PyTorch version.

- ``self_stats_reference`` against an exact numpy int64 recount of the
  Gram and moments, tolerance 0, lags 0-3, on small planes and the 12-bit
  0/max checkerboard: the reference the card comparison of chip_smoke.py
  and tests/test_torch_cuda.py rests on;
- ``_unpack_self_stats``, which turns the card kernel's int64 sums into the
  statistics, against a direct construction of the Gram from the same
  synthetic buffer (lags 0-3, luma and chroma), tolerance 0;
- ``NoiseEstimator.push_batch`` pools the luma once a batch for Cb and Cr.

The blur (K8) against the JAX blur and ``self_stats`` (K9) against the JAX
statistics, through the estimate path's functions, are cases of the tests
in test_torch_estimate.py.
"""

import numpy as np
import pytest
import torch

from grav1synth_tpu_torch.ops import diff_estimate as de
from grav1synth_tpu_torch.ops import estimate as te
from grav1synth_tpu_torch.ops import estimate_kernels as ek
from grav1synth_tpu_torch.ops.diff_kernels import NUM_BINS, offsets

from test_torch_cuda import checkerboard
from test_torch_estimate import _planes


def _recount(q, den, blocks, lsum, n_pool, lag, bd):
    """Exact int64 sums in numpy (the Gram of the masked design, n_ar, and
    the bins' count, sum of q and sum of q^2), finished by the same float64
    scaling as the port (``_finish``)."""
    b, h, w = q.shape
    q, den, blocks = (t.numpy().astype(np.int64) for t in (q, den, blocks))
    offs = offsets(lag)
    p = len(offs) + (lsum is not None)
    gram = np.zeros((b, p, p), np.int64)
    n_ar = np.zeros(b, np.int64)
    mom = np.zeros((b, 3, NUM_BINS), np.int64)
    for i in range(b):
        flat = np.zeros((h, w), bool)
        hb, wb = blocks.shape[1:]
        flat[: 16 * hb, : 16 * wb] = np.kron(blocks[i], np.ones((16, 16), np.int64)) != 0
        band = np.zeros((h, w), bool)
        band[ek.EDGE : h - ek.EDGE, ek.EDGE : w - ek.EDGE] = True
        rows, cols = np.nonzero(flat & band)
        design = [q[i, rows + dr, cols + dc] for dr, dc in offs]
        if lsum is not None:
            design.append(lsum[i].numpy().astype(np.int64)[rows, cols])
        x = np.stack(design)
        gram[i] = x @ x.T
        n_ar[i] = len(rows)
        bins = den[i, rows, cols] >> (bd - 6)
        qv = q[i, rows, cols]
        for k, wgt in enumerate((np.ones_like(qv), qv, qv * qv)):
            np.add.at(mom[i, k], bins, wgt)
    as64 = lambda a: torch.from_numpy(a.astype(np.float64))  # noqa: E731
    m = as64(mom)
    return ek._finish(as64(gram), as64(n_ar), m[:, 0], m[:, 1], m[:, 2],
                      None if lsum is None else n_pool)


RECOUNT_CASES = [
    # (name, h, w, bd, sub_x, sub_y)
    ("8-bit 420 40x33", 33, 40, 8, 1, 1),
    ("10-bit 422 50x48", 48, 50, 10, 1, 0),
    ("12-bit 444 31x36", 36, 31, 12, 0, 0),
    ("12-bit checkerboard 444 64x64", 64, 64, 12, 0, 0),
    ("12-bit checkerboard 420 66x65", 65, 66, 12, 1, 1),
]


@pytest.mark.parametrize("name,h,w,bd,sub_x,sub_y", RECOUNT_CASES,
                         ids=[c[0] for c in RECOUNT_CASES])
@pytest.mark.parametrize("lag", [0, 1, 2, 3])
def test_self_stats_reference_equals_int64_recount(lag, name, h, w, bd, sub_x, sub_y):
    rng = np.random.default_rng(lag * 5 + h)
    if "checkerboard" in name:
        y = checkerboard(h, w, bd)
        hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
        c = checkerboard(hc, wc, bd)
    else:
        y, c = _planes(rng, 2, h, w, bd, sub_x, sub_y)
    den_y, q_y = ek.self_blur_reference(torch.from_numpy(y), bd)
    if "checkerboard" in name:
        # inside the band, where the statistics look
        assert int(q_y[:, 4:-4, 4:-4].abs().max()) == 40 * ((1 << bd) - 1)
    den_c, q_c = ek.self_blur_reference(torch.from_numpy(c), bd)
    lsum = de.pool_sum(q_y, c.shape[1], c.shape[2], sub_x, sub_y)
    n_pool = (1 + sub_x) * (1 + sub_y)
    for q, den, aux in ((q_y, den_y, None), (q_c, den_c, lsum)):
        blocks = de.flat_blocks(den)
        assert int(blocks.sum()) > 0
        got = ek.self_stats_reference(q, den, blocks, aux, n_pool, lag, bd)
        want = _recount(q, den, blocks, aux, n_pool, lag, bd)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert torch.equal(got[k], want[k]), (name, k)


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("lag", [0, 1, 2, 3])
def test_unpack_self_stats_equals_direct_construction(lag, chroma):
    """The kernel's output layout: per frame the Gram's upper triangle row by
    row (i <= j), n_ar, then 64 bin counts, sums of q and sums of q^2."""
    rng = np.random.default_rng(40 + lag + 4 * chroma)
    p = len(offsets(lag)) + chroma
    npair = p * (p + 1) // 2
    b = 3
    buf = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, (b, npair + 1 + 3 * NUM_BINS)))
    n_pool = 4 if chroma else None
    got = ek._unpack_self_stats(buf, p, n_pool)
    gram = torch.zeros((b, p, p), dtype=torch.float64)
    k = 0
    for i in range(p):
        for j in range(i, p):
            gram[:, i, j] = gram[:, j, i] = buf[:, k].to(torch.float64)
            k += 1
    rest = buf[:, npair:].to(torch.float64)
    want = ek._finish(gram, rest[:, 0], rest[:, 1:65], rest[:, 65:129], rest[:, 129:193], n_pool)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key
    # the index map is made once per size and device
    assert ek._pair_index(p, "cpu") is ek._pair_index(p, torch.device("cpu"))


def test_push_batch_pools_the_luma_once_a_batch(monkeypatch):
    """NoiseEstimator.push_batch makes the chroma planes' pooled luma
    column once a batch, for Cb and Cr, and its statistics equal those of
    batch_self_stats_chroma, which makes it for one plane."""
    calls = []
    real = te.pool_sum

    def counting(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(te, "pool_sum", counting)
    y, c = _planes(np.random.default_rng(3), 3, 48, 64, 10, 1, 1)
    frames = [[y[i], c[i], c[i][::-1].copy()] for i in range(3)]
    est = te.NoiseEstimator((24, 1), bit_depth=10, device="cpu", calibrate=False)
    est.push_batch(frames)
    assert calls == [(24, 32, 1, 1)]
    st = te.batch_self_stats_chroma(torch.from_numpy(c), torch.from_numpy(y), 2, 10, 1, 1)
    assert len(calls) == 2
    want = np.zeros_like(est._chunk.cb.ata)
    for i in range(3):  # frame by frame, as the estimator adds them
        want += st["ata"][i].numpy()
    np.testing.assert_array_equal(est._chunk.cb.ata, want)
