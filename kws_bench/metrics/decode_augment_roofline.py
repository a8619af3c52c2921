"""The decode+augment kernel: the least time its bytes allow (each input
byte it needs read once, each output byte written once, at 3.35 TB/s)
over its captured time, in %."""

from kws_bench.peaks import HBM_BYTES_PER_S


def read(layers):
    tr = layers.get("trace")
    if not tr or not tr.get("decode_augment_bytes"):
        return None
    kernel_s = sum(s for name, (s, _) in tr["summary"]["kernels"].items()
                   if "decode_augment" in name)
    if kernel_s <= 0:
        return None
    return 100.0 * sum(tr["decode_augment_bytes"]) / HBM_BYTES_PER_S \
        / kernel_s
