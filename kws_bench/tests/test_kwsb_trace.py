"""The frozen trace summary on a canned Chrome trace."""

import gzip
import json

import pytest

from kws_bench import trace

EVENTS = [
    # host: a train step's operators, one outermost span with a child
    {"ph": "X", "cat": "cpu_op", "name": "aten::conv1d", "ts": 0, "dur": 40},
    {"ph": "X", "cat": "cpu_op", "name": "aten::cudnn_convolution",
     "ts": 5, "dur": 10},
    {"ph": "X", "cat": "cpu_op", "name": "Optimizer.step", "ts": 60,
     "dur": 50},
    # device: two overlapping kernels, a gap, a BN kernel, a copy
    {"ph": "X", "cat": "kernel", "name": "cudnn::conv_fwd", "ts": 10,
     "dur": 20},
    {"ph": "X", "cat": "kernel", "name": "decode_augment_kernel",
     "ts": 20, "dur": 20},
    {"ph": "X", "cat": "kernel",
     "name": "cudnn::bn_bw_1C11_kernel_new", "ts": 70, "dur": 10},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> "
     "Device)", "ts": 100, "dur": 5},
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1},
]


def test_summary_of_a_canned_trace():
    s = trace.summarize(EVENTS)
    assert s["activities"] == 4
    # union: [10, 40] + [70, 80] + [100, 105] us
    assert s["busy_s"] == pytest.approx(45e-6)
    assert s["ops"] == pytest.approx({"convolution": 20e-6,
                                      "decode_augment": 20e-6,
                                      "normalization": 10e-6,
                                      "copy": 5e-6})
    assert s["htod_s"] == pytest.approx(5e-6)
    assert s["kernels"]["decode_augment_kernel"] == (pytest.approx(2e-5), 1)
    # gaps [40, 70] (mid 55: no host op) and [80, 100] (mid 90: step)
    assert s["idle_gaps"] == [("no host operator", pytest.approx(30e-6)),
                              ("Optimizer.step", pytest.approx(20e-6))]


def test_breakdown_lists_at_most_ten(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": 10 * i,
               "dur": i + 1} for i in range(15)]
    path = tmp_path / "t.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    b = trace.breakdown(trace.summarize(trace.read_events(str(path))))
    assert [n for n, _ in b["device_ops"]] == [f"k{i}" for i in
                                               range(14, 4, -1)]
    assert len(b["idle_gaps"]) == 1
    assert b["idle_gaps"][0][0] == "no host operator"


def test_short_names():
    assert trace.short(
        "void at::native::(anonymous namespace)::conv_depthwise2d_forward_"
        "kernel_generic<float, int>(torch::Accessor<float, 4>, bool)") == \
        "at::native::conv_depthwise2d_forward_kernel_generic"
    assert trace.short("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"
    assert trace.short("sm90_xmma_gemm_bf16") == "sm90_xmma_gemm_bf16"


@pytest.mark.parametrize("name,cls", [
    ("cudnn::bn_fw_tr_1C11_singlread", "normalization"),
    ("void at::native::batch_norm_backward_kernel", "normalization"),
    ("sm90_xmma_fprop_implicit_gemm", "convolution"),
    ("ampere_sgemm_128x64_tn", "matmul"),
    ("void decode_augment_kernel<long>", "decode_augment"),
    ("void at::native::reduce_kernel", "reduction"),
    ("something_else", "other"),
])
def test_op_classes(name, cls):
    assert trace.op_class(name) == cls
