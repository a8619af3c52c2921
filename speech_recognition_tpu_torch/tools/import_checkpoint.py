"""Keras HDF5 -> checkpoint of the port (the port's counterpart of
scripts/import_checkpoint.py).

    python -m speech_recognition_tpu_torch.tools.import_checkpoint \\
        --hdf5 ep-062-vl-0.1815.hdf5 --out imported.pt \\
        [--model conv_1d_time_sliced_with_attention] [...]

Brings a reference-era Keras checkpoint (train.py:65-68) into the port:
its weights go into the zoo model by ``export/keras_import.py`` (the JAX
package's matching algorithm, over the model's flax-layout skeleton),
and the result is written as a checkpoint of the port
(``train/checkpoint.py``) at step 0 with a fresh optimizer state, which
``tools.train --resume``, ``tools.evaluate``, ``tools.make_submission``
and ``tools.freeze`` read. The flags and defaults are the JAX script's;
``--out`` names the checkpoint file. Runs on the host (h5py is needed).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Keras HDF5 -> checkpoint of the PyTorch port")
    p.add_argument("--hdf5", required=True,
                   help="Keras checkpoint written by the reference's "
                        "ModelCheckpoint (train.py:65-68)")
    p.add_argument("--out", required=True,
                   help="checkpoint file to write")
    p.add_argument("--model", default="conv_1d_time_sliced_with_attention")
    p.add_argument("--output_representation", default="raw")
    p.add_argument("--wanted_only", action="store_true")
    p.add_argument("--extend_reversed", action="store_true")
    p.add_argument("--window_size_ms", type=float, default=30.0)
    p.add_argument("--window_stride_ms", type=float, default=10.0)
    p.add_argument("--dct_coefficient_count", type=int, default=80)
    p.add_argument("--num_log_mel_features", type=int, default=60)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> str:
    """Write the checkpoint; returns its path."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.export.keras_import import (
        import_keras_state_dict,
    )
    from speech_recognition_tpu_torch.labels import (
        get_classes, prepare_words_list,
    )
    from speech_recognition_tpu_torch.models.zoo import (
        build_model, settings_geometry,
    )
    from speech_recognition_tpu_torch.train.checkpoint import save_checkpoint
    from speech_recognition_tpu_torch.train.loop import TrainState
    from speech_recognition_tpu_torch.train.optim import build_optimizer

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
    model.load_state_dict(import_keras_state_dict(args.hdf5, model,
                                                  args.model))
    optimizer = build_optimizer(spec.optimizer, model.parameters(),
                                spec.learning_rate, spec.momentum)
    save_checkpoint(args.out, TrainState(model=model, optimizer=optimizer))
    n_params = sum(p.numel() for p in model.parameters())
    n_stats = sum(b.numel() for name, b in model.named_buffers()
                  if name.endswith(("running_mean", "running_var")))
    print(f"Imported {os.path.basename(args.hdf5)} -> {args.out} "
          f"(model={args.model}, {n_params} params, "
          f"{n_stats} BN statistics; step 0, fresh optimizer state)")
    return args.out


if __name__ == "__main__":
    main()
