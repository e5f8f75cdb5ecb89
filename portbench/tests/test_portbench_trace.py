"""The trace reduction on a made-up trace: busy time, the program's
kernels, the idle gaps by host operation, annotations left out."""

from torch._C._autograd import DeviceType

from conftest import ROOT
from portbench.trace import (SWEEP, WINDOW, port_kernel_names,
                             summarize)


class Ev:
    def __init__(self, name, start, end, device="CPU", kind="cpu_op",
                 tid=7):
        self._n, self._s, self._d = name, start, end - start
        self._dev, self._kind, self._tid = device, kind, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return getattr(DeviceType, self._dev)

    def is_user_annotation(self):
        return self._kind.endswith("user_annotation")

    def start_thread_id(self):
        return self._tid


def test_port_kernels_from_sources():
    names = port_kernel_names(ROOT / "aiyagari_hark_tpu_torch/ops/csrc")
    assert {"egm_policy_kernel", "stationary_lottery_kernel",
            "fused_cell_kernel"} <= names


def test_summary_of_a_made_up_trace():
    s = 1_000_000_000
    events = [
        Ev(WINDOW, 0, 10 * s, kind="user_annotation"),
        Ev(SWEEP, 0, 10 * s, kind="user_annotation"),
        Ev("aten::nonzero", 2 * s, 4 * s),
        Ev("cudaStreamSynchronize", 2 * s, 2 * s + s // 2,
           kind="cuda_runtime"),
        Ev("aten::index", 6 * s, 8 * s),
        Ev("other thread op", 0, 10 * s, tid=8),
        Ev(SWEEP, 0, 10 * s, device="CUDA", kind="gpu_user_annotation"),
        Ev("void (anonymous namespace)::stationary_lottery_kernel<double, "
           "2, 8>(int const*, double*)", 0, 2 * s, "CUDA", "kernel"),
        Ev("void egm_policy_kernel<double, 1>(double const*)",
           4 * s, 5 * s, "CUDA", "kernel"),
        Ev("Memcpy DtoH (Device -> Pageable)", 5 * s, 6 * s, "CUDA",
           "gpu_memcpy"),
        Ev("void at::native::reduce_kernel<512>(at::native::ReduceOp)",
           9 * s, 11 * s, "CUDA", "kernel"),
    ]
    t = summarize(events, {"stationary_lottery_kernel",
                           "egm_policy_kernel"})
    assert t.window_s == 10.0
    assert t.busy_s == 2 + 1 + 1 + 1          # clipped at the window's end
    assert t.port_s == 3.0 and t.port_union_s == 3.0
    assert t.port_launches == 2
    ops = dict(t.device_ops)
    assert ops["stationary_lottery_kernel<double, 2, 8>"] == 2.0
    assert ops["at::native::reduce_kernel<512>"] == 1.0
    assert ops["Memcpy DtoH"] == 1.0
    assert SWEEP not in ops
    gaps = dict(t.idle_gaps)
    # gaps 2-4 (midpoint 3: the nonzero, the sync ended), 6-9 (the
    # index at 7.5 s)
    assert gaps == {"aten::nonzero": 2.0, "aten::index": 3.0}


def test_no_window_no_summary():
    assert summarize([Ev("aten::add", 0, 5)], set()) is None
