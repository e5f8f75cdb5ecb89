"""The CUDA kernels' plain versions against the TPU kernels, and the
wrappers' dispatch.

On the CPU a wrapper runs its kernel's plain version; the CUDA kernels
themselves run only on the card (``chip_smoke.py`` holds each against its
plain version there).  Here each plain version is held against the Pallas
kernel it replaces, run in interpret mode as ``tests/test_pallas_parity.py``
runs it: ``egm_policy_grid_plain`` against ``egm_policy_pallas`` and
``egm_policy_pallas_grid``; ``stationary_lottery_grid_plain`` against
``stationary_dense_pallas`` and ``stationary_dense_pallas_grid`` fed the
``S`` that the JAX ``dense_wealth_operator`` builds from the same lottery.

Tolerance: step counts equal; values ``rtol=1e-9, atol=1e-8`` (the JAX
kernel-parity tolerance).  The dense TPU kernel sums each target's mass
inside a matrix product, the lottery kernel in source order, so the two
round differently at 1e-17; the counts still agree on these inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.models.household as jh
import aiyagari_hark_tpu_torch.models.household as th
from aiyagari_hark_tpu.ops.pallas_kernels import (
    egm_policy_pallas,
    egm_policy_pallas_grid,
    stationary_dense_pallas,
    stationary_dense_pallas_grid,
)
from aiyagari_hark_tpu_torch.carry import model_from_numpy
from aiyagari_hark_tpu_torch.ops import kernels as K
from aiyagari_hark_tpu_torch.ops.interp import _bracket

torch.set_num_threads(1)
TOL_KW = dict(rtol=1e-9, atol=1e-8)
SMALL = dict(labor_states=3, a_count=12, dist_count=48)
PRICES = [(1.02, 1.0, 2.0), (1.035, 1.2, 5.0)]


@pytest.fixture(scope="module")
def models():
    jm = jh.build_simple_model(**SMALL)
    return jm, model_from_numpy([np.asarray(f) for f in jm], device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scalars(R, W, crra, b=0.0):
    return np.asarray([R, W, 0.96, crra, b], dtype=np.float64)


def _egm_inputs(jm, lanes):
    p0 = jh.initial_policy(jm)
    C = len(lanes)
    rep = lambda x: np.repeat(np.asarray(x)[None], C, axis=0)  # noqa: E731
    return (rep(p0.m_knots), rep(p0.c_knots), rep(jm.a_grid),
            rep(jm.labor_levels), rep(jm.transition),
            np.stack([_scalars(*p) for p in lanes]))


def test_egm_plain_matches_single_lane_pallas(models):
    jm, _ = models
    args = _egm_inputs(jm, PRICES[:1])
    m, c, it, diff = egm_policy_pallas(
        *(jnp.asarray(a[0]) for a in args), 1e-6, interpret=True)
    tm, tc, tit, tdiff = K.egm_policy_grid_plain(
        *(torch.tensor(a) for a in args), 1e-6)
    assert tit.tolist() == [int(it)]
    np.testing.assert_allclose(_np(tm[0]), np.asarray(m), **TOL_KW)
    np.testing.assert_allclose(_np(tc[0]), np.asarray(c), **TOL_KW)
    np.testing.assert_allclose(float(tdiff[0]), float(diff), rtol=1e-6)


def test_egm_plain_matches_pallas_lane_grid(models):
    jm, _ = models
    args = _egm_inputs(jm, PRICES)
    m, c, it, diff = egm_policy_pallas_grid(
        *(jnp.asarray(a) for a in args), 1e-6, interpret=True)
    tm, tc, tit, tdiff = K.egm_policy_grid_plain(
        *(torch.tensor(a) for a in args), 1e-6)
    assert tit.tolist() == np.asarray(it).tolist()
    np.testing.assert_allclose(_np(tm), np.asarray(m), **TOL_KW)
    np.testing.assert_allclose(_np(tc), np.asarray(c), **TOL_KW)


def _lotteries(jm, lanes):
    out = []
    for R, W, crra in lanes:
        pol, _, _, _ = jh.solve_household(R, W, jm, 0.96, crra)
        out.append(jh.wealth_transition(pol, R, W, jm))
    return out


def test_dist_plain_matches_single_lane_dense_pallas(models):
    jm, _ = models
    trans = _lotteries(jm, PRICES[:1])[0]
    S = jh.dense_wealth_operator(trans, 48)
    d0 = jh.initial_distribution(jm)
    dist, it, diff = stationary_dense_pallas(S, jm.transition, d0, 1e-10,
                                             5000, 64, interpret=True)
    td, tit, tdiff = K.stationary_lottery_grid_plain(
        torch.tensor(np.asarray(trans.idx))[None],
        torch.tensor(np.asarray(trans.weight))[None],
        torch.tensor(np.asarray(jm.transition))[None],
        torch.tensor(np.asarray(d0))[None], 1e-10, 5000, 64)
    assert tit.tolist() == [int(it)]
    np.testing.assert_allclose(_np(td[0]), np.asarray(dist), **TOL_KW)
    np.testing.assert_allclose(float(tdiff[0]), float(diff), rtol=1e-3)


def test_dist_plain_matches_dense_pallas_lane_grid(models):
    jm, _ = models
    trans = _lotteries(jm, PRICES)
    S = jnp.stack([jh.dense_wealth_operator(t, 48) for t in trans])
    P = jnp.stack([jm.transition] * 2)
    d0 = jnp.stack([jh.initial_distribution(jm)] * 2)
    dist, it, diff = stationary_dense_pallas_grid(S, P, d0, 1e-10, 5000, 64,
                                                  interpret=True)
    td, tit, _ = K.stationary_lottery_grid_plain(
        torch.tensor(np.stack([np.asarray(t.idx) for t in trans])),
        torch.tensor(np.stack([np.asarray(t.weight) for t in trans])),
        torch.tensor(np.asarray(P)), torch.tensor(np.asarray(d0)), 1e-10,
        5000, 64)
    assert tit.tolist() == np.asarray(it).tolist()
    np.testing.assert_allclose(_np(td), np.asarray(dist), **TOL_KW)


def test_wrappers_run_the_plain_versions_on_cpu_without_counting(models):
    jm, tm = models
    K.reset_launches()
    args = [torch.tensor(a) for a in _egm_inputs(jm, PRICES)]
    out = K.egm_policy_grid(*args, 1e-6)
    ref = K.egm_policy_grid_plain(*args, 1e-6)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    trans = _lotteries(jm, PRICES[:1])[0]
    dargs = (torch.tensor(np.asarray(trans.idx))[None],
             torch.tensor(np.asarray(trans.weight))[None],
             tm.transition[None], th.initial_distribution(tm)[None])
    for a, b in zip(K.stationary_lottery_grid(*dargs, 1e-10),
                    K.stationary_lottery_grid_plain(*dargs, 1e-10)):
        assert torch.equal(a, b)
    fargs = (*args[:2], args[2], tm.dist_grid.expand(2, -1), *args[3:],
             torch.zeros(2, 3, dtype=torch.float64),
             th.initial_distribution(tm).expand(2, -1, -1), 1e-6)
    for a, b in zip(K.fused_cell_grid(*fargs), K.fused_cell_grid_plain(*fargs)):
        assert torch.equal(a, b)
    assert K.LAUNCHES == {"egm_policy_grid": 0, "stationary_lottery_grid": 0,
                          "fused_cell_grid": 0}


def test_wrappers_validate_shapes_and_dtypes(models):
    jm, _ = models
    args = [torch.tensor(a) for a in _egm_inputs(jm, PRICES)]
    with pytest.raises(ValueError, match="do not agree"):
        K.egm_policy_grid(args[0], args[1][:1], *args[2:], 1e-6)
    with pytest.raises(ValueError, match="dtype"):
        K.egm_policy_grid(args[0].float(), *args[1:], 1e-6)
    d = torch.zeros(1, 48, 3, dtype=torch.float64)
    idx = torch.zeros(1, 48, 3, dtype=torch.int64)
    with pytest.raises(ValueError, match="do not agree"):
        K.stationary_lottery_grid(idx, d, torch.eye(2)[None].double(), d,
                                  1e-10)


def test_lottery_csr_lists_every_source_in_scatter_order(models):
    jm, _ = models
    trans = _lotteries(jm, PRICES)
    idx = torch.tensor(np.stack([np.asarray(t.idx) for t in trans]))
    w = torch.tensor(np.stack([np.asarray(t.weight) for t in trans]))
    start, src, coef = K.lottery_csr(idx, w)
    C, D, N = idx.shape
    assert tuple(start.shape) == (C, N, D + 1) and start.dtype == torch.int32
    rng = np.random.default_rng(3)
    dist = torch.tensor(rng.random((C, D, N)))
    for c in range(C):
        for n in range(N):
            st = start[c, n].tolist()
            assert st[0] == 0 and st[-1] == 2 * D
            for t in range(D):
                ks = range(st[t], st[t + 1])
                acc = torch.zeros((), dtype=torch.float64)
                for k in ks:
                    s = int(src[c, n, k])
                    assert int(idx[c, s, n]) in (t, t - 1)
                    acc = acc + dist[c, s, n] * coef[c, n, k]
                ref = (dist[c, :, n] * (1 - w[c, :, n]))[idx[c, :, n] == t]
                ref2 = (dist[c, :, n] * w[c, :, n])[idx[c, :, n] + 1 == t]
                seq = torch.zeros((), dtype=torch.float64)
                for v in torch.cat([ref, ref2]):
                    seq = seq + v
                assert torch.equal(acc, seq)


@pytest.mark.parametrize("m", [1, 2, 7, 64, 231, 1000])
def test_pairwise_sum_is_the_documented_tree(m):
    rng = np.random.default_rng(m)
    x = torch.tensor(rng.standard_normal((3, m)))
    out = th.pairwise_sum(x)
    np.testing.assert_allclose(_np(out), _np(x.sum(dim=1)), rtol=1e-12,
                               atol=1e-12)
    p = 1 << max(m - 1, 0).bit_length()
    ref = list(np.concatenate([_np(x), np.zeros((3, p - m))], axis=1).T)
    while len(ref) > 1:
        ref = [ref[2 * i] + ref[2 * i + 1] for i in range(len(ref) // 2)]
    np.testing.assert_array_equal(_np(out), ref[0])


def _chunked_pairwise_sum(x: np.ndarray, threads: int,
                          blocks: int = 1) -> np.ndarray:
    """The kernels' buffer-free pairwise sum (``csrc/common.cuh``:
    ``chunk_pairwise``, ``warp_tree``, ``tree_combine``; across a cluster,
    ``csrc/egm_device.cuh``) on each row of ``x`` [C, m], in ``x``'s
    dtype: of ``blocks`` blocks of ``threads`` threads, the first nb (a
    power of two) hold nt = min(threads nb, p) threads that own p / nt
    contiguous leaves each (zeros past m), sum them by a binary counter,
    then warp shuffles join the nodes (at offset o lane i adds lane i + o,
    or itself past lane 31), then each block's warp partials the same way,
    then the blocks' partials in rank order the same way."""
    C, m = x.shape
    p = 1 << max(m - 1, 0).bit_length()
    gp = 1
    while 2 * gp <= blocks:
        gp *= 2
    nt = min(threads * gp, p)
    ntb = min(threads, nt)
    nb = nt // ntb
    L = p // nt
    leaves = np.concatenate([x, np.zeros((C, p - m), x.dtype)], axis=1)
    chunks = leaves.reshape(C, nt, L)
    acc, v = {}, None
    for i in range(L):
        v = chunks[:, :, i]
        lv = 0
        while (i >> lv) & 1:
            v = acc[lv] + v
            lv += 1
        acc[lv] = v
    node = np.zeros((C, nb, threads), x.dtype)   # threads past nt pass 0
    node[:, :, :ntb] = v.reshape(C, nb, ntb)

    def warp_tree(vals, width):              # vals [..., 32]
        o = 1
        while o < width:
            src = np.arange(32) + o
            src = np.where(src < 32, src, np.arange(32))
            vals = vals + vals[..., src]
            o <<= 1
        return vals[..., 0]

    part = warp_tree(node.reshape(C, nb, threads // 32, 32), min(ntb, 32))
    nw = ntb >> 5 if ntb > 32 else 1
    lanes = np.zeros((C, nb, 32), x.dtype)
    lanes[:, :, :nw] = part[:, :, :nw]
    block = warp_tree(lanes, nw)             # [C, nb]
    ranks = np.zeros((C, 32), x.dtype)
    ranks[:, :nb] = block
    return warp_tree(ranks, nb)


# threads of one block, or of a cluster: 2048 = 8 blocks of 256, 4096 =
# 8 of 512 (the fine EGM lane), 2560 = 5 of 512 (N = 9 or 10 states)
CLUSTERS = {2048: (256, 8), 2560: (512, 5), 4096: (512, 8)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("threads", [512, 1024, 2048, 2560, 4096])
@pytest.mark.parametrize("m", [1, 7, 500, 3276, 3500, 15000, 30030])
def test_kernel_chunked_sum_is_the_pairwise_tree(m, threads, dtype):
    rng = np.random.default_rng(m + threads)
    x = rng.standard_normal((3, m)).astype(dtype)
    out = _chunked_pairwise_sum(x, *CLUSTERS.get(threads, (threads, 1)))
    ref = th.pairwise_sum(torch.from_numpy(x))
    assert out.dtype == dtype
    np.testing.assert_array_equal(out, _np(ref))


def _walked_brackets(xp: np.ndarray, x: np.ndarray, run: int) -> np.ndarray:
    """``csrc/egm_device.cuh``'s bracket search for rising queries ``x``
    on knots ``xp`` [K]: each run of ``run`` queries finds its first
    bracket by binary search, then walks it forward; the index is clipped
    to [0, K-2]."""
    K = xp.shape[0]
    out = np.empty(x.shape[0], dtype=np.int64)
    lo = 0
    for i, q in enumerate(x):
        if i % run == 0:
            lo, hi = 0, K
            while lo < hi:
                mid = (lo + hi) >> 1
                if xp[mid] <= q:
                    lo = mid + 1
                else:
                    hi = mid
        else:
            while lo < K and xp[lo] <= q:
                lo += 1
        out[i] = min(max(lo - 1, 0), K - 2)
    return out


@pytest.mark.parametrize("run", [1, 4, 59])
@pytest.mark.parametrize("K", [2, 33, 1001])
def test_bracket_walk_is_clipped_searchsorted(K, run):
    rng = np.random.default_rng(K * 100 + run)
    xp = np.cumsum(rng.uniform(0.01, 2.0, K)) - 1.0      # strictly rising
    q = np.concatenate([rng.uniform(xp[0] - 5.0, xp[-1] + 5.0, 3 * K),
                        xp[rng.integers(0, K, K)],          # on the knots
                        [xp[0] - 10.0, xp[-1] + 10.0]])
    q = np.sort(q)
    ref = _bracket(torch.from_numpy(xp), torch.from_numpy(q))
    np.testing.assert_array_equal(_walked_brackets(xp, q, run), ref.numpy())


@pytest.mark.parametrize("shared, cluster, force_global, layout", [
    (13_064, 1_728, False, "shared"),          # N=7, A=32, f64
    (K.MAX_WORKSPACE_SHARED_BYTES, 0, False, "shared"),
    (850_760, 122_136, False, "cluster"),      # N=15, A=1000, f64
    (K.MAX_WORKSPACE_SHARED_BYTES + 1, K.MAX_WORKSPACE_SHARED_BYTES, False,
     "cluster"),
    (K.MAX_WORKSPACE_SHARED_BYTES + 1, K.MAX_WORKSPACE_SHARED_BYTES + 1,
     False, "global"),
    (1_000_000, 2 ** 64 - 1, False, "global"),  # one state: no cluster
    (13_064, 1_728, True, "global"),
    (850_760, 122_136, True, "global"),
])
def test_egm_layout_is_chosen_by_size_alone(shared, cluster, force_global,
                                            layout):
    assert K.EGM_LAYOUTS[K._egm_layout(shared, cluster,
                                       force_global)] == layout


def test_egm_force_global_on_cpu_runs_the_plain_version(models):
    jm, _ = models
    args = [torch.tensor(a) for a in _egm_inputs(jm, PRICES)]
    K.reset_launches()
    for a, b in zip(K.egm_policy_grid(*args, 1e-6, force_global=True),
                    K.egm_policy_grid_plain(*args, 1e-6)):
        assert torch.equal(a, b)
    assert K.LAUNCHES["egm_policy_grid"] == 0


def test_egm_plain_matches_pallas_lane_grid_at_fifteen_states():
    """The fine width's state count (N=15) on a narrow asset grid."""
    jm = jh.build_simple_model(labor_states=15, a_count=48, dist_count=60)
    args = _egm_inputs(jm, PRICES)
    m, c, it, diff = egm_policy_pallas_grid(
        *(jnp.asarray(a) for a in args), 1e-6, interpret=True)
    tm, tc, tit, tdiff = K.egm_policy_grid_plain(
        *(torch.tensor(a) for a in args), 1e-6)
    assert tit.tolist() == np.asarray(it).tolist()
    np.testing.assert_allclose(_np(tm), np.asarray(m), **TOL_KW)
    np.testing.assert_allclose(_np(tc), np.asarray(c), **TOL_KW)
    np.testing.assert_allclose(_np(tdiff), np.asarray(diff), rtol=1e-6)


def test_force_global_on_cpu_runs_the_plain_version(models):
    jm, tm = models
    trans = _lotteries(jm, PRICES)
    dargs = (torch.tensor(np.stack([np.asarray(t.idx) for t in trans])),
             torch.tensor(np.stack([np.asarray(t.weight) for t in trans])),
             tm.transition.expand(2, -1, -1),
             th.initial_distribution(tm).expand(2, -1, -1), 1e-10)
    K.reset_launches()
    for a, b in zip(K.stationary_lottery_grid(*dargs, force_global=True),
                    K.stationary_lottery_grid(*dargs)):
        assert torch.equal(a, b)
    assert K.LAUNCHES["stationary_lottery_grid"] == 0


@pytest.mark.parametrize("full, no_best, force_global, layout", [
    (210_432, 182_432, False, "shared"),
    (K.MAX_WORKSPACE_SHARED_BYTES, 0, False, "shared"),
    (K.MAX_WORKSPACE_SHARED_BYTES + 1, 200_000, False,
     "shared_best_in_output"),
    (540_060, 480_060, False, "global"),
    (210_432, 182_432, True, "global"),
])
def test_lottery_layout_is_chosen_by_size_alone(full, no_best, force_global,
                                                layout):
    sizes = {1: full, 0: no_best}
    assert K.LAYOUTS[K._lottery_layout(sizes.__getitem__,
                                       force_global)] == layout


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    from aiyagari_hark_tpu_torch.device import resolve_device
    from aiyagari_hark_tpu_torch.models.equilibrium import (
        solve_calibration, solve_calibration_lean)
    from aiyagari_hark_tpu_torch.parallel.sweep import run_table2_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: th.build_simple_model(**SMALL),
                 lambda: solve_calibration_lean(3.0, 0.6, **SMALL),
                 lambda: solve_calibration(3.0, 0.6, **SMALL),
                 lambda: run_table2_sweep(**SMALL),
                 lambda: model_from_numpy([np.zeros(2)] * 6)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
