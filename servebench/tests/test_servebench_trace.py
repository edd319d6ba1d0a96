"""The trace reducer on synthetic events: busy time is the union of device
operations inside the window, spans are not device operations, K1 is
counted by its kernel's name, and idle gaps go to the host's phase."""
import torch

from servebench import trace


class Ev:
    def __init__(self, name, s, e, device=True, span=False):
        self._n, self._s, self._e, self._d, self._u = name, s, e, device, span

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._u


def test_summary_of_a_small_trace():
    ms = 1_000_000
    events = [
        Ev("servebench.serve", 0, 100 * ms, span=True),          # a span, not device work
        Ev("nvjet_gemm", 2 * ms, 10 * ms),
        Ev("void (anonymous namespace)::fa_fwd_kernel<128, 2>(...)", 9 * ms, 20 * ms),
        Ev("nvjet_gemm", 20 * ms + 50_000, 30 * ms),              # a 50 us launch gap
        Ev("nvjet_gemm", 35 * ms, 40 * ms),                        # a 5 ms gap
        Ev("void (anonymous namespace)::fa_fwd_kernel<128, 2>(...)", 95 * ms, 130 * ms),
        Ev("aten::mm", 0, 200 * ms, device=False),
    ]
    calls = [(1 * ms, 50 * ms), (90 * ms, 110 * ms)]
    out = trace.summarize(events, 0, 100 * ms, calls)
    assert out["window_s"] == 0.1
    assert out["busy_s"] == (18 * ms + 10 * ms - 50_000 + 5 * ms + 5 * ms) / 1e9
    assert out["k1_calls"] == 2 and out["k1_s"] == (11 * ms + 5 * ms) / 1e9
    assert out["device_ops"][0][0] == "nvjet_gemm"
    idle = dict(out["idle_gaps"])
    assert idle["in serve: planning before its first kernel"] == 2 * ms / 1e9
    assert idle["in serve: gaps under 0.1 ms"] == 50_000 / 1e9
    assert idle["in serve: gaps 1-10 ms"] == 5 * ms / 1e9
    assert idle["between serve calls"] == 55 * ms / 1e9
    assert abs(sum(idle.values()) + out["busy_s"] - out["window_s"]) < 1e-12
