"""Export a checkpoint for the edge (the port's counterpart of
scripts/freeze.py; parity: freeze_graph.py / freeze_graph_32_classes.py).

    python -m speech_recognition_tpu_torch.tools.freeze \\
        --checkpoint_path CKPT.pt [--frozen_path edge_files/frozen.pt2] \\
        [--weight_dtype {float32,int8}] [--map_to_12] [--batch_size 1] \\
        [--device cuda]

Writes a ``torch.export`` archive (``export/aot.py``) of the checkpoint's
model: waveform [batch_size, 16000] float32 -> class probabilities, the
weights stored in it (``--weight_dtype int8``: per-channel int8 and
scales, dequantized inside the program), ``--map_to_12`` adding the
32->12 max-unknown head. The archive is exported on the CPU; then it is
loaded on ``--device`` (default ``cuda``; the CPU only when asked) and
run once on a silent batch, which must give finite probabilities that
sum to one. The flags and defaults are the JAX script's, but for
``--device`` and the archive's default path.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Export a checkpoint for the edge (PyTorch port)")
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--frozen_path", default="edge_files/frozen.pt2")
    p.add_argument("--model", default="conv_1d_time_sliced_with_attention")
    p.add_argument("--output_representation", default="raw")
    p.add_argument("--wanted_only", action="store_true")
    p.add_argument("--extend_reversed", action="store_true")
    p.add_argument("--map_to_12", action="store_true")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--weight_dtype", default="float32",
                   choices=["float32", "int8"],
                   help="int8 = per-channel weight-only quantization "
                        "(f32 compute)")
    p.add_argument("--window_size_ms", type=float, default=30.0)
    p.add_argument("--window_stride_ms", type=float, default=10.0)
    p.add_argument("--dct_coefficient_count", type=int, default=80)
    p.add_argument("--num_log_mel_features", type=int, default=60)
    p.add_argument("--device", default="cuda",
                   help="where the archive is checked: 'cuda' (default) "
                        "or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> str:
    """Write the archive; returns its path."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.export.aot import (
        export_inference, load_exported, save_exported,
    )
    from speech_recognition_tpu_torch.labels import (
        get_classes, prepare_words_list,
    )
    from speech_recognition_tpu_torch.models.zoo import (
        build_model, settings_geometry,
    )
    from speech_recognition_tpu_torch.ops.frontend import Frontend

    device = (require_cuda() if args.device == "cuda"
              else torch.device(args.device))
    words = prepare_words_list(get_classes(
        wanted_only=args.wanted_only, extend_reversed=args.extend_reversed))
    settings = prepare_model_settings(
        label_count=len(words),
        window_size_ms=args.window_size_ms,
        window_stride_ms=args.window_stride_ms,
        dct_coefficient_count=args.dct_coefficient_count,
        num_log_mel_features=args.num_log_mel_features,
        output_representation=args.output_representation)
    model, spec = build_model(args.model, num_classes=len(words),
                              **settings_geometry(settings))
    model.load_state_dict(torch.load(args.checkpoint_path,
                                     map_location="cpu",
                                     weights_only=True)["model"])
    artifact = export_inference(
        model, Frontend(settings, "highest"), spec.representation,
        desired_samples=settings.desired_samples,
        batch_size=args.batch_size, map_to_12=args.map_to_12,
        extend_reversed=args.extend_reversed,
        weight_dtype=args.weight_dtype)
    os.makedirs(os.path.dirname(args.frozen_path) or ".", exist_ok=True)
    save_exported(args.frozen_path, artifact)
    probs = load_exported(artifact, device)(torch.zeros(
        args.batch_size, settings.desired_samples))
    if not (torch.isfinite(probs).all() and torch.allclose(
            probs.sum(-1), torch.ones((), device=device), atol=1e-4)):
        raise RuntimeError(f"the archive's probabilities on {device} do "
                           f"not sum to one: {probs}")
    print(f"Wrote frozen artifact to: {args.frozen_path} "
          f"({len(artifact)} bytes; ran on {device})")
    return args.frozen_path


if __name__ == "__main__":
    main()
