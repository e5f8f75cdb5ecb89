"""The hand-written CUDA fixed-point kernels, their plain PyTorch
versions, the build and loader, and the launch counters.

``egm_policy_grid`` replaces the TPU kernels ``egm_policy_pallas`` and
``egm_policy_pallas_grid``; ``stationary_lottery_grid`` replaces
``stationary_dense_pallas`` and ``stationary_dense_pallas_grid``;
``fused_cell_grid`` (both fixed points of a supply evaluation in one
launch) replaces ``fused_cell_pallas`` and ``fused_cell_pallas_grid``
(``aiyagari_hark_tpu/ops/pallas_kernels.py``).  Each takes a leading lane
axis ``C``; a single cell is ``C = 1``.

Dispatch: a wrapper runs its plain version only for tensors on the CPU.
For CUDA tensors it launches its kernel or raises -- there is no fallback.
The kernels are compiled from ``csrc/`` by ``nvcc`` for ``sm_90a`` at
first use, one shared library per source (built in parallel), into
``_build/`` beside this file, and bound with ``ctypes``.  They are built
with contraction on, as PyTorch's own kernels are, so that libdevice's
``pow`` rounds as ``torch.pow`` does on the card; every product the
kernels write is rounded on its own (``csrc/common.cuh``, ``mul``), as
the plain versions' separate elementwise operations round it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .interp import interp1d_rowwise
from .utility import inverse_marginal_utility, marginal_utility

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = {
    "egm_policy_grid": "egm_policy_grid.cu",
    "stationary_lottery_grid": "stationary_lottery_grid.cu",
    "fused_cell_grid": "fused_cell_grid.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=true", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
# Shared memory one block may use on an H100 (232,448 bytes), and the part
# a lane's workspace may take: 1 KB stays for the kernels' static shared
# arrays.  A workspace above it goes to global memory (same arithmetic).
MAX_SHARED_BYTES = 232448
MAX_WORKSPACE_SHARED_BYTES = MAX_SHARED_BYTES - 1024
# The distribution kernels' layouts, by the code the kernels take: the
# whole lane in global memory; the lottery and the iterates in shared
# memory, the best iterate in the output; all of it in shared memory.
LAYOUTS = ("global", "shared_best_in_output", "shared")
# The EGM kernel's layouts, by the code it takes: one block on a global
# workspace; one block, all in shared memory; a thread-block cluster, the
# labor states split over its blocks' shared memory.
EGM_LAYOUTS = ("global", "shared", "cluster")

# Launch counters: one plain integer per kernel, advanced only where the
# wrapper launches its kernel (never by a plain version).
LAUNCHES = {name: 0 for name in SOURCES}

_LIBS: dict = {}
BUILD_LOGS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels cannot be built")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for f in [_CSRC / SOURCES[name], *sorted(_CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _bind(lib, name: str) -> None:
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    ull = ctypes.c_ulonglong
    if name == "egm_policy_grid":
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"egm_policy_grid_{sfx}")
            fn.argtypes = [vp] * 11 + [ci, ci, ci, ci, cd, ci, ci, vp]
            fn.restype = ci
        for fn in (lib.egm_policy_grid_workspace_bytes,
                   lib.egm_policy_grid_cluster_bytes):
            fn.argtypes = [ci, ci, ci]
            fn.restype = ull
        lib.egm_policy_grid_cluster_blocks.argtypes = [ci]
        lib.egm_policy_grid_cluster_blocks.restype = ci
    elif name == "fused_cell_grid":
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"fused_cell_grid_{sfx}")
            fn.argtypes = [vp] * 17 + [ci] * 6 + [cd, ci, ci, cd, ci, ci, vp]
            fn.restype = ci
        lib.fused_cell_grid_workspace_bytes.argtypes = [ci] * 6
        lib.fused_cell_grid_workspace_bytes.restype = ull
        lib.fused_cell_grid_max_states.argtypes = []
        lib.fused_cell_grid_max_states.restype = ci
    else:
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"stationary_lottery_grid_{sfx}")
            fn.argtypes = [vp] * 9 + [ci] * 4 + [cd, ci, ci, vp]
            fn.restype = ci
        lib.stationary_lottery_grid_max_states.argtypes = []
        lib.stationary_lottery_grid_max_states.restype = ci
        lib.stationary_lottery_grid_shared_bytes.argtypes = [ci] * 4
        lib.stationary_lottery_grid_shared_bytes.restype = ull
        lib.stationary_lottery_grid_scratch_elems.argtypes = [ci, ci]
        lib.stationary_lottery_grid_scratch_elems.restype = ull


def build_libraries(names=tuple(SOURCES)) -> float:
    """Compile (one ``nvcc`` per source, all started together) and load
    the named kernels' libraries; a library whose sources and flags are
    unchanged is loaded from ``_build/``.  Returns the seconds taken.
    Raises ``RuntimeError`` with the compiler's output if a build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if n not in _LIBS]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in todo:
        so = BUILD_DIR / f"{name}-{_digest(name)}.so"
        if so.exists():
            continue
        tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    failed = []
    for name, (proc, tmp, so) in jobs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    for name in todo:
        lib = ctypes.CDLL(str(BUILD_DIR / f"{name}-{_digest(name)}.so"))
        _bind(lib, name)
        _LIBS[name] = lib
    return time.perf_counter() - t0


def _library(name: str):
    if name not in _LIBS:
        build_libraries((name,))
    return _LIBS[name]


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _workspace(nbytes: int, C: int, use: bool, dev):
    """A [C, nbytes] global workspace (rows 16-byte aligned) if ``use``,
    else an empty one (the lane lives in shared memory)."""
    if not use:
        return torch.empty((0,), dtype=torch.uint8, device=dev)
    row = -(-nbytes // 16) * 16
    return torch.empty((max(C, 1), row), dtype=torch.uint8, device=dev)


def _lottery_layout(nbytes, force_global: bool) -> int:
    """Index into ``LAYOUTS`` of a distribution kernel's layout, by size
    alone (never after a failure): ``nbytes(best)`` is a lane's
    shared-memory workspace with (1) or without (0) the best iterate."""
    if force_global:
        return 0
    if nbytes(1) <= MAX_WORKSPACE_SHARED_BYTES:
        return 2
    return 1 if nbytes(0) <= MAX_WORKSPACE_SHARED_BYTES else 0


def _egm_layout(shared_bytes: int, cluster_bytes: int,
                force_global: bool) -> int:
    """Index into ``EGM_LAYOUTS`` of the EGM kernel's layout, by size
    alone (never after a failure): ``shared_bytes`` is a lane's workspace
    in one block, ``cluster_bytes`` what each block of a cluster lane
    holds (huge where the lane cannot be split)."""
    if force_global:
        return 0
    if shared_bytes <= MAX_WORKSPACE_SHARED_BYTES:
        return 1
    return 2 if cluster_bytes <= MAX_WORKSPACE_SHARED_BYTES else 0


def _check(name: str, tensors: dict, dtype, device) -> None:
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, expected "
                             f"{dtype}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: dtype must be float32 or float64, got "
                         f"{dtype}")


# ---------------------------------------------------------------------------
# EGM policy fixed point.
# ---------------------------------------------------------------------------

def egm_step_lanes(m_k, c_k, a, levels, P, scalars):
    """One EGM backward step for every lane: knots ``m_k``/``c_k``
    [C, N, A+1], ``a`` [C, A], ``levels`` [C, N], ``P`` [C, N, N],
    ``scalars`` [C, 5] = (R, W, beta, crra, borrow_limit).

    The expectation over next states is summed in state order, each
    product rounded before its sum -- the order the kernel uses."""
    R, W, beta, crra, b = (scalars[:, i, None, None] for i in range(5))
    n = levels.shape[1]
    m_next = R * a[:, None, :] + W * levels[:, :, None]        # [C, N', A]
    c_next = interp1d_rowwise(m_next, m_k, c_k)
    vp = marginal_utility(c_next, crra)                         # [C, N', A]
    e = P[:, :, 0, None] * vp[:, None, 0, :]                    # [C, N, A]
    for sp in range(1, n):
        e = e + P[:, :, sp, None] * vp[:, None, sp, :]
    c_now = inverse_marginal_utility(beta * R * e, crra)
    m_now = a[:, None, :] + c_now
    eps = torch.full_like(c_now[:, :, :1], 1e-7)
    return (torch.cat([b + eps, m_now], dim=-1),
            torch.cat([eps, c_now], dim=-1))


def egm_policy_grid_plain(m0, c0, a_grid, levels, P, scalars, tol: float,
                          max_iter: int = 3000, accel_every: int = 32):
    """Plain PyTorch version of the EGM kernel: ``egm_step_lanes`` under
    the same accelerated loop (``models.household.
    accelerated_policy_fixed_point``), lanes batched with per-lane active
    masks.  Returns (m [C,N,K], c [C,N,K], iters [C] int32, diff [C])."""
    from ..models.household import (HouseholdPolicy,
                                    accelerated_policy_fixed_point)

    pol, it, diff, _ = accelerated_policy_fixed_point(
        lambda p: HouseholdPolicy(*egm_step_lanes(p.m_knots, p.c_knots,
                                                  a_grid, levels, P,
                                                  scalars)),
        HouseholdPolicy(m0, c0), tol, max_iter, accel_every)
    return pol.m_knots, pol.c_knots, it, diff


def _egm_sizes(N: int, A: int, dtype):
    lib = _library("egm_policy_grid")
    f64 = int(dtype == torch.float64)
    return (int(lib.egm_policy_grid_workspace_bytes(N, A, f64)),
            int(lib.egm_policy_grid_cluster_bytes(N, A, f64)))


def egm_policy_grid_layout(N: int, A: int, dtype,
                           force_global: bool = False) -> str:
    """The layout ``egm_policy_grid`` runs a lane of N labor states and A
    assets in on the card (an entry of ``EGM_LAYOUTS``)."""
    return EGM_LAYOUTS[_egm_layout(*_egm_sizes(N, A, dtype), force_global)]


def egm_policy_grid(m0, c0, a_grid, levels, P, scalars, tol: float,
                    max_iter: int = 3000, accel_every: int = 32,
                    force_global: bool = False):
    """Batched EGM policy fixed points, one lane per thread block or per
    thread-block cluster.

    Args: ``m0``/``c0`` [C, N, A+1] initial knots, ``a_grid`` [C, A],
    ``levels`` [C, N], ``P`` [C, N, N], ``scalars`` [C, 5] packed
    (R, W, beta, crra, borrow_limit).  Returns (m [C, N, A+1],
    c [C, N, A+1], iters [C] int32, diff [C]); the status is rebuilt
    from (iters, diff) by ``classify_fixed_point_exit``.

    A lane lives in one block's shared memory when it fits; else, split
    by labor state, in the shared memory of a cluster of up to 8 blocks;
    else in a global workspace (``egm_policy_grid_layout``).  The
    arithmetic and its order are the same, so the layouts agree bitwise.
    ``force_global`` takes the global layout at any size (a check of that
    claim)."""
    dev, dt = m0.device, m0.dtype
    C, N, K = m0.shape
    A = K - 1
    if c0.shape != m0.shape or a_grid.shape != (C, A) \
            or levels.shape != (C, N) or P.shape != (C, N, N) \
            or scalars.shape != (C, 5):
        raise ValueError(
            f"egm_policy_grid: shapes m0 {tuple(m0.shape)}, c0 "
            f"{tuple(c0.shape)}, a {tuple(a_grid.shape)}, levels "
            f"{tuple(levels.shape)}, P {tuple(P.shape)}, scalars "
            f"{tuple(scalars.shape)} do not agree")
    _check("egm_policy_grid", dict(m0=m0, c0=c0, a_grid=a_grid,
                                   levels=levels, P=P, scalars=scalars),
           dt, dev)
    if dev.type == "cpu":
        return egm_policy_grid_plain(m0, c0, a_grid, levels, P, scalars,
                                     tol, max_iter, accel_every)
    lib = _library("egm_policy_grid")
    f64 = dt == torch.float64
    args = [t.contiguous() for t in (m0, c0, a_grid, levels, P, scalars)]
    m = torch.empty_like(args[0])
    c = torch.empty_like(args[0])
    iters = torch.empty((C,), dtype=torch.int32, device=dev)
    diff = torch.empty((C,), dtype=dt, device=dev)
    if C == 0:
        return m, c, iters, diff
    shared_bytes, cluster_bytes = _egm_sizes(N, A, dt)
    layout = _egm_layout(shared_bytes, cluster_bytes, force_global)
    ws = _workspace(shared_bytes, C, layout == 0, dev)
    fn = lib.egm_policy_grid_f64 if f64 else lib.egm_policy_grid_f32
    rc = fn(*(_ptr(t) for t in args), _ptr(m), _ptr(c), _ptr(iters),
            _ptr(diff), _ptr(ws), layout, C, N, A, float(tol),
            int(max_iter), int(accel_every), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"egm_policy_grid: kernel launch failed with "
                           f"CUDA error {rc} ({EGM_LAYOUTS[layout]} layout)")
    LAUNCHES["egm_policy_grid"] += 1
    return m, c, iters, diff


# ---------------------------------------------------------------------------
# Stationary-distribution fixed point.
# ---------------------------------------------------------------------------

def lottery_targets(idx: torch.Tensor, weight: torch.Tensor):
    """The lottery's contributions in the order the JAX scatter adds
    them: for each lane and labor state, every left-neighbour share in
    source order, then every right-neighbour share in source order.
    Returns (target [C, N, 2D], source row [C, N, 2D], coefficient
    [C, N, 2D])."""
    C, D, N = idx.shape
    tgt = torch.cat([idx, idx + 1], dim=1).transpose(1, 2)
    w = weight.transpose(1, 2)
    coef = torch.cat([1.0 - w, w], dim=-1)
    src = torch.arange(D, device=idx.device).repeat(2)
    return tgt, src.expand(C, N, 2 * D), coef


def lottery_csr(idx: torch.Tensor, weight: torch.Tensor):
    """The lottery grouped by target, stable in contribution order: a
    CSR per (lane, labor state).  Returns (start [C, N, D+1] int32,
    source row [C, N, 2D] int32, coefficient [C, N, 2D])."""
    C, D, N = idx.shape
    tgt, src, coef = lottery_targets(idx, weight)
    order = torch.argsort(tgt, dim=-1, stable=True)
    tgt_sorted = torch.gather(tgt, -1, order)
    bounds = torch.arange(D + 1, device=idx.device, dtype=tgt.dtype)
    start = torch.searchsorted(tgt_sorted.contiguous(),
                               bounds.expand(C, N, D + 1).contiguous())
    return (start.to(torch.int32).contiguous(),
            torch.gather(src, -1, order).to(torch.int32).contiguous(),
            torch.gather(coef, -1, order).contiguous())


def lottery_gather(idx: torch.Tensor, weight: torch.Tensor):
    """The lottery as a gather, padded to the largest in-degree: for every
    target (lane, gridpoint, labor state), flattened as [C*D*N], its
    sources in ``lottery_csr`` order.  Returns (source [Kmax, C*D*N]
    int64 index into the flattened distribution, coefficient
    [Kmax, C*D*N]); a padding slot has coefficient 0 and reads gridpoint 0
    of its own lane and state, so a non-finite lane stays its own."""
    C, D, N = idx.shape
    dev = idx.device
    start, src, coef = lottery_csr(idx, weight)
    tgt, _, _ = lottery_targets(idx, weight)
    tgt = torch.sort(tgt, dim=-1, stable=True).values          # [C, N, 2D]
    rank = (torch.arange(2 * D, device=dev)
            - torch.gather(start.long(), -1, tgt))
    kmax = int(rank.max()) + 1
    lane = torch.arange(C, device=dev)[:, None, None].expand_as(tgt)
    state = torch.arange(N, device=dev)[None, :, None].expand_as(tgt)
    flat = (lane * D + tgt) * N + state
    col = torch.arange(C * D * N, device=dev)
    src_pad = (col // (D * N) * (D * N) + col % N).expand(kmax, -1).clone()
    coef_pad = torch.zeros((kmax, C * D * N), dtype=coef.dtype, device=dev)
    src_pad[rank, flat] = (lane * D + src.long()) * N + state
    coef_pad[rank, flat] = coef
    return src_pad, coef_pad


def push_forward_lanes(dist, src_pad, coef_pad, P):
    """One push-forward step for every lane: each target sums its lottery
    shares from 0 left to right in ``lottery_csr`` order -- the kernel's
    order, on every device (a padding slot adds +0.0, which changes no
    bit) -- then the labor states mix in state order.  ``dist``
    [C, D, N], ``(src_pad, coef_pad)`` from ``lottery_gather``, ``P``
    [C, N, N]."""
    C, D, N = dist.shape
    vals = dist.reshape(-1)[src_pad] * coef_pad
    moved = torch.zeros_like(vals[0])
    for k in range(vals.shape[0]):
        moved = moved + vals[k]
    moved = moved.reshape(C, D, N)
    out = moved[:, :, 0, None] * P[:, None, 0, :]
    for n in range(1, N):
        out = out + moved[:, :, n, None] * P[:, None, n, :]
    return out


def stationary_lottery_grid_plain(idx, weight, P, dist0, tol: float,
                                  max_iter: int = 20000,
                                  accel_every: int = 64):
    """Plain PyTorch version of the distribution kernel:
    ``push_forward_lanes`` under the same accelerated loop
    (``models.household.accelerated_distribution_fixed_point``: Aitken
    extrapolation, 512-step stall exit, best certified iterate), lanes
    batched with per-lane active masks.  Returns (dist [C, D, N],
    iters [C] int32, diff [C]); ``diff`` is the best residual, or the
    last one when that was non-finite."""
    from ..models.household import distribution_loop

    src, coef = lottery_gather(idx, weight)
    best_dist, it, best, last = distribution_loop(
        lambda d: push_forward_lanes(d, src, coef, P), dist0, tol, max_iter,
        accel_every)
    return best_dist, it, torch.where(torch.isfinite(last), best, last)


def _stationary_layout(D: int, N: int, dtype, force_global: bool) -> int:
    lib = _library("stationary_lottery_grid")
    f64 = int(dtype == torch.float64)
    return _lottery_layout(
        lambda best: int(lib.stationary_lottery_grid_shared_bytes(
            D, N, f64, best)), force_global)


def stationary_lottery_grid_layout(D: int, N: int, dtype,
                                   force_global: bool = False) -> str:
    """The layout ``stationary_lottery_grid`` runs a [D, N] lane in on the
    card (an entry of ``LAYOUTS``)."""
    return LAYOUTS[_stationary_layout(D, N, dtype, force_global)]


def stationary_lottery_grid(idx, weight, P, dist0, tol: float,
                            max_iter: int = 20000, accel_every: int = 64,
                            force_global: bool = False):
    """Batched stationary distributions of the Young-lottery operator,
    one lane per thread block.

    Args: ``idx`` [C, D, N] left-neighbour index and ``weight`` [C, D, N]
    right-neighbour share (``WealthTransition``), ``P`` [C, N, N],
    ``dist0`` [C, D, N].  Returns (dist [C, D, N], iters [C] int32,
    diff [C]); the status is rebuilt from (iters, diff).

    A lane's lottery and iterates live in shared memory when they fit one
    block's share (the best iterate too when it fits), else in global
    memory; the arithmetic and its order are the same, so the layouts
    agree bitwise.  ``force_global`` takes the global layout at any size
    (a check of that claim)."""
    dev, dt = dist0.device, dist0.dtype
    C, D, N = dist0.shape
    if idx.shape != dist0.shape or weight.shape != dist0.shape \
            or P.shape != (C, N, N):
        raise ValueError(
            f"stationary_lottery_grid: shapes idx {tuple(idx.shape)}, "
            f"weight {tuple(weight.shape)}, P {tuple(P.shape)}, dist0 "
            f"{tuple(dist0.shape)} do not agree")
    _check("stationary_lottery_grid", dict(weight=weight, P=P, dist0=dist0),
           dt, dev)
    if idx.device != dev:
        raise ValueError(f"stationary_lottery_grid: idx is on {idx.device}, "
                         f"expected {dev}")
    if dev.type == "cpu":
        return stationary_lottery_grid_plain(idx, weight, P, dist0, tol,
                                             max_iter, accel_every)
    lib = _library("stationary_lottery_grid")
    max_n = int(lib.stationary_lottery_grid_max_states())
    if N > max_n:
        raise ValueError(f"stationary_lottery_grid: N={N} labor states "
                         f"(D={D}) exceeds the kernel's {max_n}")
    start, src, coef = lottery_csr(idx, weight)
    # each source as its element d N + n of the flattened [D, N] iterate
    elem = (src * N + torch.arange(N, dtype=src.dtype, device=dev)[:, None]
            ).contiguous()
    P = P.contiguous()
    dist0 = dist0.contiguous()
    dist = torch.empty_like(dist0)
    iters = torch.empty((C,), dtype=torch.int32, device=dev)
    diff = torch.empty((C,), dtype=dt, device=dev)
    if C == 0:
        return dist, iters, diff
    layout = _stationary_layout(D, N, dt, force_global)
    per_lane = (int(lib.stationary_lottery_grid_scratch_elems(D, N))
                if layout == 0 else 0)
    scratch = torch.empty((C, per_lane), dtype=dt, device=dev)
    f64 = dt == torch.float64
    fn = (lib.stationary_lottery_grid_f64 if f64
          else lib.stationary_lottery_grid_f32)
    rc = fn(_ptr(start), _ptr(elem), _ptr(coef), _ptr(P), _ptr(dist0),
            _ptr(dist), _ptr(iters), _ptr(diff), _ptr(scratch), layout, C,
            D, N, float(tol), int(max_iter), int(accel_every), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"stationary_lottery_grid: kernel launch failed "
                           f"with CUDA error {rc}")
    LAUNCHES["stationary_lottery_grid"] += 1
    return dist, iters, diff


# ---------------------------------------------------------------------------
# Both fixed points of a supply evaluation in one launch.
# ---------------------------------------------------------------------------

def fused_cell_grid_plain(m0, c0, a_grid, dist_grid, levels, P, scalars, h,
                          d0, tol: float, max_iter: int = 3000,
                          accel_every: int = 32, dist_tol: float = 1e-11,
                          dist_max_iter: int = 20000, dist_accel: int = 64,
                          tail: bool = False):
    """Plain PyTorch version of the fused kernel, from the port's plain
    pieces: ``egm_step_lanes`` (closed by the analytic tail if ``tail``)
    under the accelerated policy loop, ``household.wealth_transition`` on
    the final knots, then ``stationary_lottery_grid_plain``.  Same
    signature and results as ``fused_cell_grid``."""
    from ..models.household import (HouseholdPolicy, SimpleModel,
                                    _append_analytic_tail_knots,
                                    accelerated_policy_fixed_point,
                                    wealth_transition)
    from .utility import asymptotic_mpc

    R, W, beta, crra, b = (scalars[:, i] for i in range(5))
    kappa = asymptotic_mpc(R, beta, crra)

    def step(p):
        m, c = egm_step_lanes(p.m_knots, p.c_knots, a_grid, levels, P,
                              scalars)
        if tail:
            m, c = _append_analytic_tail_knots(m, c, kappa, h)
        return HouseholdPolicy(m, c)

    pol, egm_it, egm_diff, _ = accelerated_policy_fixed_point(
        step, HouseholdPolicy(m0, c0), tol, max_iter, accel_every)
    # labor_stationary is a placeholder: the transition does not read it
    model = SimpleModel(a_grid, levels, P, levels, dist_grid, b)
    trans = wealth_transition(pol, R, W, model)
    dist, dist_it, dist_diff = stationary_lottery_grid_plain(
        trans.idx, trans.weight, P, d0, dist_tol, dist_max_iter, dist_accel)
    return (pol.m_knots, pol.c_knots, dist, egm_it, egm_diff, dist_it,
            dist_diff)


def _fused_layout(N: int, A: int, D: int, tail: bool, dtype,
                  force_global: bool) -> int:
    lib = _library("fused_cell_grid")
    f64 = int(dtype == torch.float64)
    return _lottery_layout(
        lambda best: int(lib.fused_cell_grid_workspace_bytes(
            N, A, D, int(tail), f64, best)), force_global)


def fused_cell_grid_layout(N: int, A: int, D: int, tail: bool, dtype,
                           force_global: bool = False) -> str:
    """The layout ``fused_cell_grid`` runs a lane in on the card (an entry
    of ``LAYOUTS``)."""
    return LAYOUTS[_fused_layout(N, A, D, tail, dtype, force_global)]


def fused_cell_grid(m0, c0, a_grid, dist_grid, levels, P, scalars, h, d0,
                    tol: float, max_iter: int = 3000, accel_every: int = 32,
                    dist_tol: float = 1e-11, dist_max_iter: int = 20000,
                    dist_accel: int = 64, tail: bool = False,
                    force_global: bool = False):
    """Batched supply evaluations, one lane per thread block: the EGM
    policy fixed point, the savings policy on the histogram support, the
    lottery grouped by target, and the stationary distribution, in one
    launch.

    Args: ``m0``/``c0`` [C, N, K] initial knots (K = A+1, or A+3 with
    ``tail``: every iterate closed by the analytic tail), ``a_grid``
    [C, A], ``dist_grid`` [C, D], ``levels`` [C, N], ``P`` [C, N, N],
    ``scalars`` [C, 5] packed (R, W, beta, crra, borrow_limit), ``h``
    [C, N] the tail's human wealth (zeros without ``tail``), ``d0``
    [C, D, N].  Returns (m [C, N, K], c [C, N, K], dist [C, D, N],
    egm_iters [C] int32, egm_diff [C], dist_iters [C] int32,
    dist_diff [C]); the statuses are rebuilt from the (iters, diff)
    pairs.  ``force_global``: as for ``stationary_lottery_grid``; the
    workspace holds the lottery, then one region that the EGM phase and
    the sort use first and the distribution iterates then."""
    dev, dt = m0.device, m0.dtype
    C, N, K = m0.shape
    A = a_grid.shape[-1]
    D = dist_grid.shape[-1]
    if K != A + (3 if tail else 1) or c0.shape != m0.shape \
            or a_grid.shape != (C, A) or dist_grid.shape != (C, D) \
            or levels.shape != (C, N) or P.shape != (C, N, N) \
            or scalars.shape != (C, 5) or h.shape != (C, N) \
            or d0.shape != (C, D, N):
        raise ValueError(
            f"fused_cell_grid: shapes m0 {tuple(m0.shape)}, c0 "
            f"{tuple(c0.shape)}, a {tuple(a_grid.shape)}, dist_grid "
            f"{tuple(dist_grid.shape)}, levels {tuple(levels.shape)}, P "
            f"{tuple(P.shape)}, scalars {tuple(scalars.shape)}, h "
            f"{tuple(h.shape)}, d0 {tuple(d0.shape)} do not agree "
            f"(tail={tail})")
    _check("fused_cell_grid", dict(m0=m0, c0=c0, a_grid=a_grid,
                                   dist_grid=dist_grid, levels=levels, P=P,
                                   scalars=scalars, h=h, d0=d0), dt, dev)
    if dev.type == "cpu":
        return fused_cell_grid_plain(m0, c0, a_grid, dist_grid, levels, P,
                                     scalars, h, d0, tol, max_iter,
                                     accel_every, dist_tol, dist_max_iter,
                                     dist_accel, tail)
    lib = _library("fused_cell_grid")
    max_n = int(lib.fused_cell_grid_max_states())
    if N > max_n:
        raise ValueError(f"fused_cell_grid: N={N} labor states exceeds the "
                         f"kernel's {max_n}")
    f64 = dt == torch.float64
    args = [t.contiguous() for t in (m0, c0, a_grid, dist_grid, levels, P,
                                     scalars, h, d0)]
    m = torch.empty_like(args[0])
    c = torch.empty_like(args[0])
    dist = torch.empty_like(args[8])
    egm_it = torch.empty((C,), dtype=torch.int32, device=dev)
    egm_diff = torch.empty((C,), dtype=dt, device=dev)
    dist_it = torch.empty((C,), dtype=torch.int32, device=dev)
    dist_diff = torch.empty((C,), dtype=dt, device=dev)
    outs = (m, c, dist, egm_it, egm_diff, dist_it, dist_diff)
    if C == 0:
        return outs
    layout = _fused_layout(N, A, D, tail, dt, force_global)
    # a global workspace (without the best iterate) only for layout 0
    ws = _workspace(int(lib.fused_cell_grid_workspace_bytes(
        N, A, D, int(tail), int(f64), 0)), C, layout == 0, dev)
    fn = lib.fused_cell_grid_f64 if f64 else lib.fused_cell_grid_f32
    rc = fn(*(_ptr(t) for t in args), *(_ptr(t) for t in outs), _ptr(ws),
            layout, int(tail), C, N, A, D, float(tol),
            int(max_iter), int(accel_every), float(dist_tol),
            int(dist_max_iter), int(dist_accel), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fused_cell_grid: kernel launch failed with "
                           f"CUDA error {rc}")
    LAUNCHES["fused_cell_grid"] += 1
    return outs
