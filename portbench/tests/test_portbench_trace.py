"""Reading a device trace: busy time as the union of device intervals,
kernels given to the program's CUDA sources by name and to named regions
by where their launch fell, idle gaps by the host event that covers them."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench.harness import trace


def ev(name, device, start, end, eid=0, thread=1):
    return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(start=start, end=end),
                           id=eid, thread=thread, is_async=False, is_user_annotation=False)


def test_kernel_sources_are_the_programs():
    sources = trace.kernel_sources()
    assert sources["gather_grouped_kernel"] == "csrc/gather_rows.cu"
    assert sources["count_ge_kernel"] == "csrc/count_ge.cu"
    assert sources["short_attention_kernel"] == "csrc/short_attention.cu"


def test_read_attributes_and_merges():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        ev("portbench/topk", cpu, 100, 200, thread=1),
        ev("cudaLaunchKernel", cpu, 110, 112, eid=7, thread=1),   # inside the region
        ev("cudaLaunchKernel", cpu, 150, 152, eid=8, thread=2),   # another thread
        ev("cudaLaunchKernel", cpu, 300, 302, eid=9, thread=1),   # after it
        ev("aten::copy_", cpu, 400, 480, eid=3, thread=1),
        ev("void at::native::reduce_kernel<512>", cuda, 120, 160, eid=7),
        ev("void (anonymous namespace)::count_ge_kernel<true>(float const*)", cuda, 155, 170, eid=8),
        ev("void gather_grouped_kernel<__nv_bfloat16>(...)", cuda, 310, 330, eid=9),
        ev("Memcpy DtoD (Device -> Device)", cuda, 500, 520, eid=11),
    ]
    prof = SimpleNamespace(events=lambda: events)
    p = trace.read(prof, window_s=1e-3, annotations=("portbench/topk",))
    assert p.busy_s == pytest.approx((170 - 120 + 20 + 20) / 1e6)
    assert p.idle_share == pytest.approx(1 - 90e-6 / 1e-3)
    assert p.device_s(regions=["portbench/topk"]) == pytest.approx(40e-6)
    assert p.device_s(files=["csrc/count_ge.cu"]) == pytest.approx(15e-6)
    assert p.device_s(files=["csrc/count_ge.cu"], regions=["portbench/topk"]) == pytest.approx(55e-6)
    assert p.device_s(files=["csrc/gather_rows.cu"]) == pytest.approx(20e-6)
    gaps = dict(p.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(170e-6)  # the gap 330..500: its middle under the copy
    assert gaps["host: no traced event"] == pytest.approx(140e-6)  # 170..310
    assert p.device_ops(2)[0][0].startswith("void at::native::reduce_kernel")


def test_host_window_reads_this_process():
    from portbench.harness.common import host_state, host_window

    start = host_state()
    sum(i * i for i in range(300000))
    got = host_window(start, host_state())
    assert got["wall_s"] > 0 and 0.0 < got["process_cores"] < 64
