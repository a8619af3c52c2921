"""Accuracy calibration on the shared-spectrum hard corpus (the port's
counterpart of scripts/calibrate_accuracy.py).

    python -m speech_recognition_tpu_torch.tools.calibrate_accuracy \\
        [--model conv_1d_spec] [--epochs 12] [--seed 0] [--device cuda]

Trains one model through the reference recipe on the hard corpus
(``data/hard_corpus.py``: the classes share one tone inventory and
differ in temporal order, six word pairs alias each other in pitch, and
an SNR sweep keeps accuracy off the 1.0 ceiling), with ReduceLROnPlateau
(factor 0.5, patience 4, min lr 1e-5) and BN re-estimation before each
validation sweep, and prints one JSON line with the accuracy record:
the JAX script's keys. One line per epoch goes to stderr.
``--eval_int8`` exports the trained model in float32 and in int8 at
batch 64 (``export/aot.py``), runs the validation clips through both
archives on the device and adds ``aot_f32_acc``, ``aot_int8_acc`` and
``int8_delta`` to the record (scripts/calibrate_accuracy.py:163-191).

The flags and defaults are the JAX script's, but for ``--device``
(default ``cuda``; the CPU only when asked) and ``--disable_pallas``,
which has no counterpart: the port has one decode+augment path, the
CUDA kernel on the card.

The corpus is written once per set of corpus flags under the temporary
directory (``$TMPDIR``), in a directory of the port's own
(``srt_torch_hard_corpus_<tag>``), through a sibling that is renamed into
place when complete.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import shutil
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Accuracy calibration on the hard corpus (PyTorch port)")
    p.add_argument("--model", default="conv_1d_time_sliced_with_attention")
    p.add_argument("--clips_per_word", type=int, default=100)
    p.add_argument("--corpus_seed", type=int, default=0)
    p.add_argument("--snr_lo", type=float, default=2.0)
    p.add_argument("--snr_hi", type=float, default=12.0)
    p.add_argument("--pitch_span_l", type=float, default=1.4,
                   help="pitch span in inventory steps; >1 creates the "
                        "alias-overlap Bayes ceiling (data/hard_corpus.py)")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--steps_per_epoch", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"])
    p.add_argument("--bn_recalibration_batches", type=int, default=16)
    p.add_argument("--no_bn_recal", dest="bn_recalibration_batches",
                   action="store_const", const=0)
    p.add_argument("--output_representation", default="auto",
                   help="'auto' = the model's registry representation")
    p.add_argument("--model_kwargs", default=None,
                   help="JSON dict of extra module-constructor kwargs "
                        "for ablations, e.g. '{\"head\": \"flatten\"}' "
                        "on conv_2d_fast")
    p.add_argument("--learning_rate", type=float, default=None,
                   help="override the registry recipe's LR (ablations)")
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="train steps per train_many call (the same "
                        "updates; see Trainer.fit)")
    p.add_argument("--eval_int8", action="store_true",
                   help="also report the exported float32 and int8 "
                        "archives' validation accuracy")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def corpus_dir(args: argparse.Namespace) -> pathlib.Path:
    """Where the corpus for these flags lives (the JAX script's tag over
    the same flags, under a prefix of the port's own)."""
    tag = hashlib.sha1(
        f"{args.clips_per_word}|{args.corpus_seed}|{args.snr_lo}|"
        f"{args.snr_hi}|{args.pitch_span_l}|v2".encode()).hexdigest()[:10]
    return (pathlib.Path(tempfile.gettempdir())
            / f"srt_torch_hard_corpus_{tag}" / "audio")


def ensure_corpus(args: argparse.Namespace) -> pathlib.Path:
    """The corpus directory for ``args``, written first if missing."""
    from speech_recognition_tpu_torch.data.hard_corpus import (
        build_hard_corpus,
    )

    root = corpus_dir(args)
    if root.exists():
        return root
    print(f"building hard corpus at {root}...", file=sys.stderr)
    root.parent.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=root.parent, prefix="partial-"))
    try:
        build_hard_corpus(tmp, clips_per_word=args.clips_per_word,
                          seed=args.corpus_seed,
                          snr_db_range=(args.snr_lo, args.snr_hi),
                          pitch_span_l=args.pitch_span_l)
        try:
            tmp.rename(root)
        except OSError:
            if not root.exists():   # not lost to a concurrent writer
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return root


def calibrate(args: argparse.Namespace,
              corpus_root: Optional[pathlib.Path] = None,
              ) -> Tuple[Dict[str, Any], Any, Dict[str, list]]:
    """Run the calibration for ``args`` on the corpus at ``corpus_root``
    (default: ``ensure_corpus(args)``); returns (the JSON record, the
    ``Trainer``, ``fit``'s history)."""
    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        build_device_dataset,
    )
    from speech_recognition_tpu_torch.data.hard_corpus import WANTED
    from speech_recognition_tpu_torch.data.index import build_dataset_index
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.labels import prepare_words_list
    from speech_recognition_tpu_torch.models.zoo import get_spec
    from speech_recognition_tpu_torch.train.checkpoint import (
        PlateauCallback,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer
    from speech_recognition_tpu_torch.train.optim import ReduceLROnPlateau

    device = (require_cuda() if args.device == "cuda"
              else torch.device(args.device))
    root = corpus_root or ensure_corpus(args)
    representation = args.output_representation
    if representation == "auto":
        representation = get_spec(args.model).representation
    words = prepare_words_list(WANTED)
    settings = prepare_model_settings(
        label_count=len(words), window_size_ms=30.0, window_stride_ms=10.0,
        dct_coefficient_count=80, num_log_mel_features=60,
        output_representation=representation)
    index = build_dataset_index(
        data_dirs=[str(root)], silence_percentage=13.0,
        unknown_percentage=60.0, wanted_words=WANTED,
        validation_percentage=20.0, testing_percentage=0.0)
    dataset = build_device_dataset(index, settings, device)
    trainer = Trainer(
        model_name=args.model, settings=settings, dataset=dataset,
        augment=AugmentConfig(), batch_size=args.batch_size,
        seed=args.seed, compute_dtype=args.compute_dtype,
        model_kwargs=json.loads(args.model_kwargs) if args.model_kwargs
        else None,
        learning_rate=args.learning_rate)
    state = trainer.init_state()

    class Collect:
        def on_epoch_end(self, epoch, state, logs):
            print(f"[ep {epoch:02d}] val_acc="
                  f"{logs['val_categorical_accuracy']:.4f} "
                  f"val_loss={logs['val_loss']:.4f} "
                  f"train_acc={logs['categorical_accuracy']:.4f} "
                  f"clips/s={logs['clips_per_sec']:.0f}", file=sys.stderr)
            return None

    plateau = PlateauCallback(ReduceLROnPlateau(
        factor=0.5, patience=4, min_lr=1e-5, mode="max"))
    state, history = trainer.fit(
        state, epochs=args.epochs,
        steps_per_epoch=args.steps_per_epoch or None,
        callbacks=[Collect(), plateau],
        bn_recalibration_batches=args.bn_recalibration_batches,
        steps_per_dispatch=args.steps_per_dispatch)
    accs = history["val_categorical_accuracy"]
    record = {
        "model": args.model,
        "representation": representation,
        "compute_dtype": trainer.compute_dtype,
        # the fused decode+augment kernel builds every training batch on
        # the card; on the CPU its plain version does
        "pallas_augment": device.type == "cuda",
        "bn_recal": args.bn_recalibration_batches,
        "clips_per_word": args.clips_per_word,
        "snr_db": [args.snr_lo, args.snr_hi],
        "pitch_span_l": args.pitch_span_l,
        "epochs": args.epochs,
        **({"model_kwargs": json.loads(args.model_kwargs)}
           if args.model_kwargs else {}),
        **({"learning_rate": args.learning_rate}
           if args.learning_rate else {}),
        "val_acc_final": round(accs[-1], 4),
        "val_acc_best": round(max(accs), 4),
        "val_loss_final": round(history["val_loss"][-1], 4),
    }
    if args.eval_int8:
        record.update(exported_accuracy(trainer, state))
    return record, trainer, history


def exported_accuracy(trainer, state, batch: int = 64) -> Dict[str, float]:
    """Validation accuracy of the float32 and int8 archives of the
    trained model at batch ``batch`` (full batches only, as the JAX
    script sweeps them), and their difference."""
    from speech_recognition_tpu_torch.export.aot import (
        export_inference, load_exported,
    )
    from speech_recognition_tpu_torch.ops.frontend import Frontend

    wav, labels = trainer.dataset.get_unprocessed_data("validation")
    n = wav.shape[0] // batch * batch
    accs = {}
    for dtype in ("float32", "int8"):
        fn = load_exported(export_inference(
            state.model, Frontend(trainer.settings, "highest"),
            trainer.spec.representation,
            desired_samples=trainer.settings.desired_samples,
            batch_size=batch, weight_dtype=dtype), trainer.device)
        preds = torch.cat([fn(wav[i:i + batch]).argmax(-1)
                           for i in range(0, n, batch)])
        accs[dtype] = float((preds == labels[:n]).float().mean())
    return {"aot_f32_acc": round(accs["float32"], 4),
            "aot_int8_acc": round(accs["int8"], 4),
            "int8_delta": round(accs["int8"] - accs["float32"], 4)}


def main(argv: Optional[List[str]] = None) -> int:
    record, _, _ = calibrate(parse_args(argv))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
