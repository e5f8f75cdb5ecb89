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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lottery_push_tail_is_bitwise_the_padded_gather(dtype):
    """``lottery_push`` takes the slots past ``PUSH_HEAD_SLOTS`` only for
    the targets that have them: the padded gather's bits, and a
    non-finite lane stays its own."""
    rng = np.random.default_rng(11)
    C, D, N = 3, 60, 4
    near = np.arange(D)[None, :, None] + rng.integers(-2, 3, (C, D, N))
    crowd = rng.random((C, D, N)) < 0.4      # many sources on a few rows
    idx = torch.tensor(np.clip(np.where(crowd, rng.integers(0, 3, (C, D, N)),
                                        near), 0, D - 2))
    w = torch.tensor(rng.random((C, D, N)), dtype=dtype)
    w[0, :5] = 0.0                           # zero shares are real entries
    P = torch.tensor(rng.dirichlet(np.ones(N), size=(C, N)), dtype=dtype)
    src, coef = K.lottery_gather(idx, w)
    assert src.shape[0] > K.PUSH_HEAD_SLOTS
    push = K.lottery_push(idx, w, P)
    for _ in range(3):
        d = torch.tensor(rng.random((C, D, N)), dtype=dtype)
        assert torch.equal(push(d), K.push_forward_lanes(d, src, coef, P))
    d[1] = float("nan")
    out = push(d)
    assert bool(torch.isfinite(out[0]).all() and torch.isfinite(out[2]).all())


# Byte counts of stationary_lottery_grid.cu at three lanes (lottery_device.
# cuh: lottery_csr_bytes + lottery_iterate_bytes for one block, with and
# without the best iterate; lottery_cluster_bytes with no staging for each
# block of an 8-block cluster, its split list included, 41,744 bytes in
# f64 and 25,104 in f32; the transition padded to the lane's bound, 8 at
# N=7, 16 at N=15): (D, N, itemsize) -> (full, no_best, cluster)
LOTTERY_BYTES = {
    (500, 7, 8): (210_544, 182_544, 58_160),      # the paper's width
    (1000, 15, 8): (902_112, 782_112, 111_360),   # the fine width
    (1000, 15, 4): (541_088, 481_088, 63_696),
}


def _round16(b):
    return -(-b // 16) * 16


def _split_bytes(itemsize):
    """lottery_device.cuh's lottery_split_bytes, from the limits the build
    passes it."""
    return _round16((K.LOTTERY_SPLIT_SEGMENTS + 2 * K.LOTTERY_SPLIT_ENTRIES)
                    * itemsize
                    + (K.LOTTERY_SPLIT_ENTRIES + K.LOTTERY_SPLIT_SEGMENTS
                       + 2) * 4)


def _lottery_bytes(D, N, itemsize):
    """(full, no_best, cluster) as lottery_device.cuh counts them, under
    a bound on the states (not the wide mix), a cluster block's split list
    included."""
    nb = K.lottery_state_bound(N)
    p = nb * nb * itemsize
    csr = _round16(p + 2 * D * N * itemsize
                   + (N * (D + 1) + 2 * D * N) * 4)
    R = -(-D // 8)
    cluster = _round16(p + _split_bytes(itemsize) + 4 * R * N * itemsize
                       + N * (R + 1) * 4)
    return csr + 4 * D * N * itemsize, csr + 3 * D * N * itemsize, cluster


@pytest.mark.parametrize("shape", sorted(LOTTERY_BYTES))
def test_lottery_bytes_count_the_split_lists(shape):
    """The byte table above is lottery_device.cuh's count, a cluster
    block's split list of ``LOTTERY_SPLIT_ENTRIES`` entries included, and
    the one-block layouts carry none: the list moves no layout at the
    benchmark's widths (the paper's lane stays in one block's shared
    memory with its best iterate, the fine lane in the cluster, staging
    its entries)."""
    D, N, itemsize = shape
    full, no_best, cluster = _lottery_bytes(D, N, itemsize)
    assert (full, no_best, cluster) == LOTTERY_BYTES[shape]
    sizes = {1: full, 0: no_best}
    split = _split_bytes(itemsize)
    assert K._lottery_layout(sizes.__getitem__, False, cluster - split) \
        == K._lottery_layout(sizes.__getitem__, False, cluster) \
        == (2 if D == 500 else 3)
    if D == 1000:   # the stage keeps room for a block's share and more
        assert K._lottery_stage(cluster, D, N, itemsize) >= 2 * D * N // 8 * 2


def test_lottery_split_limits_reach_the_build():
    """The split's limits have one source: ``ops/kernels.py`` passes its
    ``LOTTERY_SPLIT_*`` to every build as the -D flags that
    ``lottery_device.cuh`` requires, so a change of either side reaches
    the library's digest and its byte counts."""
    flags = {f for f in K.NVCC_FLAGS if f.startswith("-DAHTT_SPLIT_")}
    assert flags == {f"-DAHTT_SPLIT_DEGREE={K.LOTTERY_SPLIT_DEGREE}",
                     f"-DAHTT_SPLIT_SEGS={K.LOTTERY_SPLIT_SEGMENTS}",
                     f"-DAHTT_SPLIT_ENTRIES={K.LOTTERY_SPLIT_ENTRIES}"}
    cuh = (K._CSRC / "lottery_device.cuh").read_text()
    for macro in ("AHTT_SPLIT_DEGREE", "AHTT_SPLIT_SEGS",
                  "AHTT_SPLIT_ENTRIES"):
        assert f"= {macro};" in cuh and f"defined({macro})" in cuh


def _lottery_lane(N, A, D, crra, rho, r=0.0415):
    """The lottery CSR starts [N, D+1] of one float64 lane at rate r, its
    policy solved on the CPU (its plain version)."""
    from aiyagari_hark_tpu_torch.models import firm

    dt = torch.float64
    model = th.stack_models([th.build_simple_model(
        labor_states=N, labor_ar=rho, a_count=A, dist_count=D, dtype=dt,
        device="cpu")])
    rr = torch.tensor([r], dtype=dt)
    R, W = 1.0 + rr, firm.wage_rate(firm.k_to_l_from_r(rr, 0.36, 0.08), 0.36)
    pol = th.solve_household(R, W, model, 0.96,
                             torch.tensor([crra], dtype=dt))[0]
    tr = th.wealth_transition(pol, R, W, model)
    return K.lottery_csr(tr.idx, tr.weight)[0][0]


@pytest.mark.parametrize("N, A, D, crra, rho, engages", [
    (15, 1000, 1000, 1.0, 0.0, True),      # the fine width's cluster
    (7, 32, 500, 1.0, 0.0, True),          # Table II, when in a cluster
    (7, 32, 500, 5.0, 0.9, False),         # every segment under the degree
])
def test_lottery_split_lists_fit_their_caps_in_a_cluster(
        N, A, D, crra, rho, engages):
    """Near r*, the (crra 1, rho 0) lanes of both widths have segments over
    ``LOTTERY_SPLIT_DEGREE`` sources (the bottom rows, where low-income
    states pile their sources), so a cluster block splits them; each of
    the eight blocks of ceil(D/8) rows fits its list whole, never past its
    caps.  A (crra 5, rho 0.9) Table II lane has none: it runs the serial
    gather alone.  The fine lane's blocks also fit their entries in the
    stage the cluster leaves beside its split list.  (At the paper's width
    the default layout is one block, which does not split: only a forced
    cluster takes these lanes there.)"""
    start = _lottery_lane(N, A, D, crra, rho)
    deg = start[:, 1:] - start[:, :-1]                  # [N, D]
    long = deg > K.LOTTERY_SPLIT_DEGREE
    assert bool(long.any()) == engages
    rows = -(-D // 8)
    stage = K._lottery_stage(_lottery_bytes(D, N, 8)[2], D, N, 8)
    for r0 in range(0, D, rows):
        blk = deg[:, r0:r0 + rows]
        segs = long[:, r0:r0 + rows]
        assert int(segs.sum()) <= K.LOTTERY_SPLIT_SEGMENTS
        assert int(blk[segs].sum()) <= K.LOTTERY_SPLIT_ENTRIES
        if D == 1000:
            assert int(blk.sum()) <= stage
    if engages:
        assert int(long.sum()) >= 4 and int(deg.max()) > 4 * \
            K.LOTTERY_SPLIT_DEGREE


@pytest.mark.parametrize("shape, force_global, layout", [
    ((500, 7, 8), False, "shared"),
    ((1000, 15, 8), False, "cluster"),
    ((1000, 15, 4), False, "cluster"),
    ((1000, 15, 8), True, "global"),
    ((1000, 15, 4), True, "global"),
    ((500, 7, 8), True, "global"),
])
def test_lottery_layout_takes_the_cluster_only_past_one_block(
        shape, force_global, layout):
    full, no_best, cluster = LOTTERY_BYTES[shape]
    sizes = {1: full, 0: no_best}
    assert K.LAYOUTS[K._lottery_layout(sizes.__getitem__, force_global,
                                       cluster)] == layout
    # a lane offered no cluster (a fused lane with a tail) never takes it
    assert K.LAYOUTS[K._lottery_layout(sizes.__getitem__,
                                       force_global)] != "cluster"


@pytest.mark.parametrize("cluster, layout", [
    (K.MAX_WORKSPACE_SHARED_BYTES, "cluster"),
    (K.MAX_WORKSPACE_SHARED_BYTES + 1, "global"),
    (2 ** 64 - 1, "global"),          # staged sources that would not pack
])
def test_lottery_cluster_needs_its_fixed_part_to_fit(cluster, layout):
    sizes = {1: 902_112, 0: 782_112}
    assert K.LAYOUTS[K._lottery_layout(sizes.__getitem__, False,
                                       cluster)] == layout


@pytest.mark.parametrize("fixed, D, N, itemsize, stage", [
    (111_360, 1000, 15, 8, 10_005),    # f64: (231424 - 111360) // 12
    (63_696, 1000, 15, 4, 20_966),     # f32: (231424 - 63696) // 8
    (59_696, 20, 3, 8, 120),           # a small lane stages all 2 D N
    (K.MAX_WORKSPACE_SHARED_BYTES, 1000, 15, 8, 0),
    (K.MAX_WORKSPACE_SHARED_BYTES + 64, 1000, 15, 8, 0),
])
def test_lottery_stage_fills_the_rest_of_a_blocks_share(fixed, D, N,
                                                        itemsize, stage):
    got = K._lottery_stage(fixed, D, N, itemsize)
    assert got == stage
    assert fixed + got * (itemsize + 4) <= max(
        fixed, K.MAX_WORKSPACE_SHARED_BYTES)


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


# -- the EGM kernel's tail mode (the compact grids' ladder) -------------------

@pytest.fixture(scope="module")
def compact():
    jm = jh.build_simple_model(grid="compact", **SMALL)
    return jm, model_from_numpy([np.asarray(f) for f in jm], device="cpu")


def _tail_inputs(tm, lanes):
    C = len(lanes)
    p0 = th.initial_policy(tm, analytic_tail=True)
    R, W, crra = (torch.tensor([p[i] for p in lanes], dtype=torch.float64)
                  for i in range(3))
    rep = lambda x: x[None].expand(C, *x.shape).contiguous()  # noqa: E731
    sc = torch.stack([R, W, torch.full_like(R, 0.96), crra,
                      torch.zeros_like(R)], dim=1)
    h = th.perfect_foresight_human_wealth(R, W, rep(tm.labor_levels),
                                          rep(tm.transition))
    return (rep(p0.m_knots), rep(p0.c_knots), rep(tm.a_grid),
            rep(tm.labor_levels), rep(tm.transition), sc), h


def test_egm_tail_mode_matches_the_fused_egm_phase_and_jax(compact):
    """``egm_policy_grid(tail=True)`` on the CPU (its plain version) is
    bitwise the fused kernel's plain EGM phase, and JAX's compact
    ``egm_step`` loop within the parity tolerance, with equal steps."""
    jm, tm = compact
    args, h = _tail_inputs(tm, PRICES)
    m, c, it, diff = K.egm_policy_grid(*args, 1e-6, h=h, tail=True)
    assert tuple(m.shape) == (2, 3, tm.a_grid.shape[0] + 3)
    C, D = 2, tm.dist_grid.shape[0]
    fused = K.fused_cell_grid_plain(
        *args[:3], tm.dist_grid.expand(C, D), *args[3:], h,
        th.initial_distribution(tm).expand(C, -1, -1), 1e-6,
        dist_max_iter=0, tail=True)
    for a, b in zip((m, c, it, diff), (fused[0], fused[1], fused[3],
                                       fused[4])):
        assert torch.equal(a, b)
    for lane, (R, W, crra) in enumerate(PRICES):
        jp, jit, jdiff, _ = jh.accelerated_policy_fixed_point(
            lambda p: jh.egm_step(p, R, W, jm, 0.96, crra,
                                  analytic_tail=True),
            jh.initial_policy(jm, analytic_tail=True), 1e-6, 3000, 32)
        assert int(it[lane]) == int(jit)
        np.testing.assert_allclose(_np(m[lane]), np.asarray(jp.m_knots),
                                   **TOL_KW)
        np.testing.assert_allclose(_np(c[lane]), np.asarray(jp.c_knots),
                                   **TOL_KW)


def test_egm_tail_mode_validates_its_inputs(compact):
    _, tm = compact
    args, h = _tail_inputs(tm, PRICES)
    with pytest.raises(ValueError, match="do not agree"):
        K.egm_policy_grid(*args, 1e-6, tail=True)               # no h
    with pytest.raises(ValueError, match="do not agree"):
        K.egm_policy_grid(*args, 1e-6, h=h[:1], tail=True)
    with pytest.raises(ValueError, match="do not agree"):
        K.egm_policy_grid(*args, 1e-6)        # A+3 knots without a tail
    with pytest.raises(ValueError, match="dtype"):
        K.egm_policy_grid(*args, 1e-6, h=h.float(), tail=True)


@pytest.mark.parametrize("N, A, dtype, shared, cluster, layout", [
    # the fine compact grid (A=851) in f64 and f32, its coarse subset
    # (A=426) and the adaptive grid (A=751) in f64: one block overflows,
    # a cluster block (2 states, K = A+3 knots) fits
    (15, 851, torch.float64, 725_848, 104_448, "cluster"),
    (15, 851, torch.float32, 362_924, 52_224, "cluster"),
    (15, 426, torch.float64, 365_448, 53_448, "cluster"),
    (15, 751, torch.float64, 641_048, 92_448, "cluster"),
    # Table II's tailed lanes (N=7: A=28 and its coarse A=15 in f64, A=28
    # in f32) fit one block: shared
    (7, 28, torch.float64, 12_712, 2_440, "shared"),
    (7, 15, torch.float64, 7_512, 1_608, "shared"),
    (7, 28, torch.float32, 6_356, 1_220, "shared"),
    # a lane no cluster splits (~0), or whose cluster blocks overflow
    (1, 100_000, torch.float64, 850_760, 2 ** 64 - 1, "global"),
    (15, 851, torch.float64, K.MAX_WORKSPACE_SHARED_BYTES + 1,
     K.MAX_WORKSPACE_SHARED_BYTES + 1, "global"),
])
def test_egm_layout_never_takes_the_cluster_with_a_tail(
        monkeypatch, N, A, dtype, shared, cluster, layout):
    """A lane closed by the tail is chosen as any other, from byte counts
    asked with the tail (K = A+3 knots a state): shared where one block
    holds it, else the cluster where its blocks fit, else global; global
    under ``force_global``.  (Before the cluster loop closed the tail, a
    tailed lane never took the cluster.)"""
    lib = _FakeLib(egm_policy_grid_workspace_bytes=shared,
                   egm_policy_grid_cluster_bytes=cluster)
    monkeypatch.setattr(K, "_library", lambda name: lib)
    assert K.egm_policy_grid_layout(N, A, dtype, tail=True) == layout
    assert K.egm_policy_grid_layout(N, A, dtype, force_global=True,
                                    tail=True) == "global"
    f64 = int(dtype == torch.float64)
    assert lib.calls and all(args == (N, A, 1, f64)
                             for _, args in lib.calls)


# ---------------------------------------------------------------------------
# Any number of labor states; the fused kernel's cluster layout.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N, bound", [
    (1, 8), (7, 8), (8, 8), (9, 16), (15, 16), (16, 16), (17, 32), (21, 32),
    (32, 32), (33, 0), (40, 0), (200, 0),
])
def test_lottery_state_bound_is_taken_by_size(N, bound):
    """The distribution loops' bound on the labor states: 8, 16 or 32 (a
    row's sums in registers), 0 past 32 (the wide mix)."""
    assert K.lottery_state_bound(N) == bound
    assert bound == 0 or N <= bound
    assert bound in K.LOTTERY_STATE_BOUNDS + (0,)


class _FakeLib:
    """The byte counts a kernel library exports, given as numbers; each
    call records its arguments."""

    def __init__(self, **sizes):
        self.sizes = sizes
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            v = self.sizes[name]
            return v(*args) if callable(v) else v
        return fn


FUSED_FINE_F64 = dict(   # N=15, A=1000, D=1000, float64
    fused_cell_grid_workspace_bytes=lambda N, A, D, nb, tail, f64, best:
        1_512_872,
    fused_cell_grid_cluster_bytes=lambda N, A, D, nb, tail, f64, stage:
        max(122_144, 111_360 + 12 * stage),
    fused_cell_grid_cluster_lottery_bytes=111_360,
)


@pytest.mark.parametrize("sizes, tail, force_global, layout, stage", [
    (FUSED_FINE_F64, False, False, "cluster", 10_005),
    # a tail moves nothing in the choice: the cluster's bytes count it
    (FUSED_FINE_F64, True, False, "cluster", 10_005),
    (FUSED_FINE_F64, False, True, "global", 0),     # never under force
    # the paper's width fits one block: shared, never the cluster
    (dict(fused_cell_grid_workspace_bytes=lambda *a: 210_544 if a[-1]
          else 182_544, fused_cell_grid_cluster_bytes=58_160,
          fused_cell_grid_cluster_lottery_bytes=58_160),
     False, False, "shared", 0),
    (dict(fused_cell_grid_workspace_bytes=lambda *a: 240_000 if a[-1]
          else 200_000, fused_cell_grid_cluster_bytes=58_160,
          fused_cell_grid_cluster_lottery_bytes=58_160),
     False, False, "shared_best_in_output", 0),
    # the cluster cannot take the lane (~0) or its blocks overflow
    (dict(fused_cell_grid_workspace_bytes=2_000_000,
          fused_cell_grid_cluster_bytes=2 ** 64 - 1,
          fused_cell_grid_cluster_lottery_bytes=111_360),
     False, False, "global", 0),
    (dict(fused_cell_grid_workspace_bytes=2_000_000,
          fused_cell_grid_cluster_bytes=K.MAX_WORKSPACE_SHARED_BYTES + 16,
          fused_cell_grid_cluster_lottery_bytes=111_360),
     False, False, "global", 0),
])
def test_fused_layout_takes_the_cluster_only_past_one_block(
        monkeypatch, sizes, tail, force_global, layout, stage):
    lib = _FakeLib(**sizes)
    monkeypatch.setattr(K, "_library", lambda name: lib)
    got, got_stage = K._fused_layout(15, 1000, 1000, tail, torch.float64,
                                     force_global)
    assert (K.LAYOUTS[got], got_stage) == (layout, stage)
    # every byte count is asked under the lane's bound on the states
    assert all(args[3] == 16 for name, args in lib.calls
               if name != "fused_cell_grid_cluster_lottery_bytes")
    assert all(args[2] == 16 for name, args in lib.calls
               if name == "fused_cell_grid_cluster_lottery_bytes")


FUSED_FINE_COMPACT_F64 = dict(   # N=15, A=851, D=926, tail, float64
    fused_cell_grid_workspace_bytes=1_339_128,
    fused_cell_grid_cluster_bytes=lambda N, A, D, nb, tail, f64, stage:
        max(104_448 if tail else 88_448, 106_496 + 12 * stage),
    fused_cell_grid_cluster_lottery_bytes=106_496,
)


@pytest.mark.parametrize("N, sizes, force_global, layout, stage", [
    # the fine compact grid: one block overflows, the tailed cluster fits
    (15, FUSED_FINE_COMPACT_F64, False, "cluster", 10_410),
    (15, FUSED_FINE_COMPACT_F64, True, "global", 0),
    # Table II's compact lane (N=7, A=28, D=468) fits one block: shared
    (7, dict(fused_cell_grid_workspace_bytes=lambda *a: 197_104 if a[-1]
             else 170_896, fused_cell_grid_cluster_bytes=57_408,
             fused_cell_grid_cluster_lottery_bytes=57_408),
     False, "shared", 0),
    # past 16 labor states no cluster takes the lane (~0): global
    (17, dict(fused_cell_grid_workspace_bytes=lambda *a: 485_632 if a[-1]
              else 421_984, fused_cell_grid_cluster_bytes=2 ** 64 - 1,
              fused_cell_grid_cluster_lottery_bytes=40_000),
     False, "global", 0),
])
def test_fused_layout_takes_the_tailed_cluster_past_one_block(
        monkeypatch, N, sizes, force_global, layout, stage):
    """With the tail (the compact grids): the cluster where one block
    overflows and the cluster's blocks fit, shared where one block holds
    the lane, global past 16 labor states and under ``force_global``;
    every byte count asked with the tail, under the lane's bound."""
    lib = _FakeLib(**sizes)
    monkeypatch.setattr(K, "_library", lambda name: lib)
    got, got_stage = K._fused_layout(N, 851, 926, True, torch.float64,
                                     force_global)
    assert (K.LAYOUTS[got], got_stage) == (layout, stage)
    nb = K.lottery_state_bound(N)
    asked = [(name, args) for name, args in lib.calls
             if name != "fused_cell_grid_cluster_lottery_bytes"]
    assert asked and all(args[3] == nb and args[4] == 1
                         for _, args in asked)


@pytest.mark.parametrize("N, bound", [(7, 8), (17, 32), (40, 0)])
def test_stationary_layout_asks_its_bytes_under_the_lanes_bound(
        monkeypatch, N, bound):
    lib = _FakeLib(stationary_lottery_grid_shared_bytes=10_000_000,
                   stationary_lottery_grid_cluster_bytes=100_000)
    monkeypatch.setattr(K, "_library", lambda name: lib)
    layout, stage = K._stationary_layout(500, N, torch.float64, False)
    assert K.LAYOUTS[layout] == "cluster"
    assert stage == K._lottery_stage(100_000, 500, N, 8)
    assert lib.calls and all(args[2] == bound for _, args in lib.calls)


@pytest.mark.parametrize("name, D, N, K_, match", [
    ("stationary_lottery_grid", 1 << 20, 64, None, "PAIRWISE_LEAVES_MAX"),
    ("fused_cell_grid", 1 << 20, 64, 33, "PAIRWISE_LEAVES_MAX"),
    ("fused_cell_grid", 1, 7, 33, "FUSED_MIN_WEALTH_POINTS"),
    ("fused_cell_grid", 500, 4096, 4097, "PAIRWISE_LEAVES_MAX"),
])
def test_wrapper_limits_raise_naming_the_limit(name, D, N, K_, match):
    with pytest.raises(ValueError, match=match):
        K._check_lane_limits(name, D, N, K_)


@pytest.mark.parametrize("D, N, K_", [
    (1000, 15, 1001), (500, 40, 33), (500, 200, 33), (32768, 1024, None),
    (2, 1, 2),
])
def test_wrapper_limits_pass_what_the_kernels_run(D, N, K_):
    K._check_lane_limits("fused_cell_grid" if K_ else
                         "stationary_lottery_grid", D, N, K_)


@pytest.mark.parametrize("N", [17, 21, 40])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_many_states_fused_is_bitwise_the_reference_chain(N, dtype):
    """Past 16 labor states on CPU tensors: ``fused_cell_grid`` is bitwise
    ``egm_policy_grid``, then ``wealth_transition``, then
    ``stationary_lottery_grid``, each wrapper on its plain version."""
    model = th.stack_models([th.build_simple_model(
        labor_states=N, a_count=12, dist_count=40, labor_ar=0.6,
        dtype=dtype, device="cpu")] * 2)
    r = torch.tensor([0.035, 0.04], dtype=dtype)
    R, W = 1.0 + r, torch.tensor([1.1, 1.2], dtype=dtype)
    egm_tol, dist_tol = (1e-6, 1e-11) if dtype == torch.float64 \
        else (1e-5, 1e-8)
    p0 = th.initial_policy(model)
    sc = th._scalars(R, W, model, 0.96, 3.0)
    m, c, eit, ediff = K.egm_policy_grid(p0.m_knots, p0.c_knots,
                                         model.a_grid, model.labor_levels,
                                         model.transition, sc, egm_tol)
    trans = th.wealth_transition(th.HouseholdPolicy(m, c), R, W, model)
    d0 = th.initial_distribution(model)
    dist, dit, ddiff = K.stationary_lottery_grid(
        trans.idx, trans.weight, model.transition, d0, dist_tol)
    out = K.fused_cell_grid(p0.m_knots, p0.c_knots, model.a_grid,
                            model.dist_grid, model.labor_levels,
                            model.transition, sc,
                            torch.zeros_like(model.labor_levels), d0,
                            egm_tol, dist_tol=dist_tol)
    for a, b in zip(out, (m, c, dist, eit, ediff, dit, ddiff)):
        assert torch.equal(a, b)
    assert bool((dit > 0).all())


@pytest.mark.parametrize("N", [17, 40])
def test_dist_plain_matches_dense_pallas_lane_grid_past_sixteen_states(N):
    """The distribution kernel's plain version at a many-state lane,
    against the TPU kernel it replaces (interpret mode), on the lottery
    of a JAX policy."""
    jm = jh.build_simple_model(labor_states=N, a_count=12, dist_count=24)
    trans = _lotteries(jm, PRICES)
    S = jnp.stack([jh.dense_wealth_operator(t, 24) for t in trans])
    P = jnp.stack([jm.transition] * 2)
    d0 = jnp.stack([jh.initial_distribution(jm)] * 2)
    dist, it, diff = stationary_dense_pallas_grid(S, P, d0, 1e-10, 5000, 64,
                                                  interpret=True)
    td, tit, _ = K.stationary_lottery_grid(
        torch.tensor(np.stack([np.asarray(t.idx) for t in trans])),
        torch.tensor(np.stack([np.asarray(t.weight) for t in trans])),
        torch.tensor(np.asarray(P)), torch.tensor(np.asarray(d0)), 1e-10,
        5000, 64)
    assert tit.tolist() == np.asarray(it).tolist()
    np.testing.assert_allclose(_np(td), np.asarray(dist), **TOL_KW)
