"""The reader of ``depthwise_device_ms_per_step`` on a synthetic kernel
summary that holds ATen's depthwise kernels and the port's."""

import pytest

from kws_bench.metrics import depthwise_device_ms_per_step as reader

ATEN = ("at::native::conv_depthwise2d_forward_kernel_generic",
        "at::native::conv_depthwise2d_backward_kernel",
        "at::native::conv_depthwise2d_grad_weight_kernel")
PORT = ("void (anonymous namespace)::dwconv1d_fw_kernel<__nv_bfloat16, 3>"
        "(__nv_bfloat16 const*, float const*, __nv_bfloat16*, "
        "(anonymous namespace)::Plan)",
        "void (anonymous namespace)::dwconv1d_bw_kernel<__nv_bfloat16, 3>"
        "(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
        "__nv_bfloat16*, float*, (anonymous namespace)::Plan)",
        "(anonymous namespace)::dwconv1d_merge_kernel(float const*, float*, "
        "int, int)")


def _layers(names, steps=20):
    kernels = {n: (0.001 * (i + 1), steps) for i, n in enumerate(names)}
    kernels["cutlass::Kernel2"] = (0.5, 40)
    kernels["at::native::vectorized_elementwise_kernel"] = (0.25, 60)
    kernels["bn_bw_dx_kernel"] = (0.125, 20)
    return {"kind": "train",
            "trace": {"steps": steps, "summary": {"kernels": kernels}}}


@pytest.mark.parametrize("names", [ATEN, PORT, ATEN + PORT],
                         ids=["aten", "port", "both"])
def test_the_reader_sums_the_depthwise_kernels_of_either_side(names):
    want = 1e3 * sum(0.001 * (i + 1) for i in range(len(names))) / 20
    assert reader.read(_layers(names)) == pytest.approx(want, rel=1e-12)


def test_nothing_to_read_is_none():
    assert reader.read(_layers(())) is None
    assert reader.read({"kind": "train", "trace": None}) is None
    assert reader.read({"kind": "predict",
                        "trace": _layers(PORT)["trace"]}) is None
