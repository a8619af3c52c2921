"""Batched TTA submission generation (the port's counterpart of
scripts/make_submission.py; parity: make_submission.py:34-213).

    python -m speech_recognition_tpu_torch.tools.make_submission \\
        --checkpoint CKPT.pt [--test_dir data/test/audio] [--tta_dir DIR] \\
        [--no_tta] [--out_prefix submission] [--device cuda]

Loads the model's weights from a checkpoint of the port
(``train/checkpoint.py``; its classes in ``labels.get_classes`` order, as
the flags give them), runs left+loud TTA over the test directory (speed
TTA too with ``--tta_dir``, a slow set from ``tools.create_tta_set``),
and writes the wanted-label
CSV, the all-label CSV, the probability CSV and, for 12 classes, the
uint8 memmap in AUDIO_NAMES order. The flags and defaults are the JAX
script's, but for ``--device`` (default ``cuda``; the CPU only when
asked).

Data parallelism (the JAX script's ``--data_parallel``)::

    torchrun --nproc_per_node W -m \\
        speech_recognition_tpu_torch.tools.make_submission \\
        --checkpoint CKPT.pt [--data_parallel {auto,on,off}] ...

``auto`` (the default) shards the sweep when a process group of more
than one rank exists (torchrun's environment; gloo for ``--device
cpu``), ``on`` raises without one, ``off`` predicts every batch whole on
every rank. Sharded, each rank decodes and predicts its B/W rows of
each batch and the probabilities are gathered. Where ``--batch_size``
does not split over the ranks, every rank predicts whole batches, as
the JAX script falls back to one device; the choice is printed. Only
rank 0 writes the files.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Batched TTA submission generation (PyTorch port)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", default="conv_1d_time_sliced_with_attention")
    p.add_argument("--test_dir", default="data/test/audio")
    p.add_argument("--tta_dir", default="",
                   help="pre-built slow set for speed TTA "
                        "(tools.create_tta_set)")
    p.add_argument("--out_prefix", default="submission")
    p.add_argument("--output_representation", default="raw")
    p.add_argument("--batch_size", type=int, default=384)
    p.add_argument("--wanted_only", action="store_true")
    p.add_argument("--extend_reversed", action="store_true")
    p.add_argument("--window_size_ms", type=float, default=25.0)
    p.add_argument("--window_stride_ms", type=float, default=15.0)
    p.add_argument("--dct_coefficient_count", type=int, default=80)
    p.add_argument("--num_log_mel_features", type=int, default=60)
    p.add_argument("--no_tta", action="store_true")
    p.add_argument("--data_parallel", default="auto",
                   choices=["auto", "on", "off"],
                   help="shard each batch over the ranks of torchrun's "
                        "process group (auto: when there is one)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def predictor_mesh(choice: str, mesh, batch_size: int):
    """The mesh the Predictor shards over for ``--data_parallel choice``
    (None: whole batches on this rank), and the line that says so."""
    if choice == "on" and mesh.size == 1:
        raise ValueError("--data_parallel on needs a process group of more "
                         "than one rank (run under torchrun)")
    if choice == "off" or mesh.size == 1:
        return None, "data parallel: off"
    if batch_size % mesh.size:
        return None, (f"data parallel: off (batch {batch_size} does not "
                      f"split over {mesh.size} ranks; each rank predicts "
                      f"whole batches)")
    return mesh, (f"data parallel: on, {mesh.size} ranks of "
                  f"{batch_size // mesh.size} clips per batch")


def main(argv: Optional[List[str]] = None) -> dict:
    """Write the submission files; returns {kind: path} (empty on ranks
    other than 0)."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.infer.submission import (
        predict_directory, to_audio_names_order, write_submission_csvs,
        write_uint8_memmap,
    )
    from speech_recognition_tpu_torch.infer.tta import Predictor, TTAConfig
    from speech_recognition_tpu_torch.labels import (
        get_classes, get_int2label, prepare_words_list,
    )
    from speech_recognition_tpu_torch.models.zoo import build_model
    from speech_recognition_tpu_torch.parallel.distributed import (
        host_replicated, join_from_env,
    )

    device, mesh = join_from_env(args.device)
    shard, choice = predictor_mesh(args.data_parallel, mesh, args.batch_size)
    print(choice)
    words = prepare_words_list(get_classes(
        wanted_only=args.wanted_only, extend_reversed=args.extend_reversed))
    settings = prepare_model_settings(
        label_count=len(words),
        window_size_ms=args.window_size_ms,
        window_stride_ms=args.window_stride_ms,
        dct_coefficient_count=args.dct_coefficient_count,
        num_log_mel_features=args.num_log_mel_features,
        output_representation=args.output_representation)
    model, spec = build_model(
        args.model, num_classes=len(words),
        spectrogram_length=settings.spectrogram_length,
        spectrogram_frequencies=settings.spectrogram_frequencies)
    model.load_state_dict(torch.load(args.checkpoint, map_location="cpu",
                                     weights_only=True)["model"])
    tta = TTAConfig(use_tta=not args.no_tta,
                    use_speed_tta=bool(args.tta_dir))
    predictor = Predictor(host_replicated(model.to(device), mesh), settings,
                          spec.representation, tta, device, mesh=shard)
    basenames, probs = predict_directory(
        predictor, args.test_dir, batch_size=args.batch_size,
        tta_dir=args.tta_dir or None, progress=mesh.rank == 0)
    if mesh.rank != 0:
        return {}
    int2label = get_int2label(wanted_only=args.wanted_only,
                              extend_reversed=args.extend_reversed)
    paths = write_submission_csvs(args.out_prefix, basenames, probs,
                                  int2label)
    if probs.shape[1] == 12:
        # the exchange format's columns are in AUDIO_NAMES order, not the
        # model's class order (see to_audio_names_order)
        paths["memmap"] = f"{args.out_prefix}_probs.uint8.memmap"
        write_uint8_memmap(paths["memmap"],
                           to_audio_names_order(probs, int2label))
    print("wrote:", paths)
    return paths


if __name__ == "__main__":
    from speech_recognition_tpu_torch.parallel.distributed import leave

    try:
        main()
    finally:
        leave()
