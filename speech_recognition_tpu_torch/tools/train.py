"""Training entry point (the port's counterpart of scripts/train.py;
parity: reference train.py:22-75).

    python -m speech_recognition_tpu_torch.tools.train \\
        [--data_dirs data/train/audio] [--model ...] [--experiment 210] \\
        [--epochs 100] [--stream] [--resume CKPT.pt] [--device cuda]

Defaults reproduce the model-210 recipe: the flagship on raw clips,
batch 384, silence 13 % / unknown 60 % / validation 10 % / test 0 %,
pseudo frequency 0.6, 100 epochs, with the reference's callbacks: the
confusion reports (``confusion_matrix.txt``,
``wanted_confusion_matrix.txt``), ReduceLROnPlateau (0.5, 4, 1e-5, max)
on the validation accuracy, a best-only checkpoint in
``checkpoints_<experiment>/`` and TensorBoard events in
``logs_<experiment>/``; each epoch's metrics are appended to
``logs_<experiment>.jsonl``. All of them go to the working directory.

``--stream`` stages only the validation partition and the background
bank on the device; the training clips stream from the files through a
``HostPrefetchLoader`` (the rank's ``process_shard`` of them), decoded
on a thread and copied while the card trains. ``--resume`` restores a
checkpoint of the port (model, optimizer, step) before training.
``--compute_dtype auto`` is bfloat16 on the card and float32 on the CPU.
The flags and defaults are the JAX script's, plus ``--device`` (default
``cuda``; the CPU only when asked).

Data parallelism, as the JAX script trains over the host's devices::

    torchrun --nproc_per_node W -m speech_recognition_tpu_torch.tools.train ...

joins the W ranks' process group from torchrun's environment (NCCL with
a card per rank, gloo when ranks share a card or on the CPU with
``--device cpu``); ``--batch_size`` is the global batch, B/W rows per
rank. Every rank stages the same data and rank 0's copy is broadcast;
in ``--stream`` mode each rank's loader holds its ``process_shard`` of
the training files and yields B/W rows. ``--resume`` gives every rank
rank 0's restored state. Only rank 0 writes the checkpoints, the
TensorBoard events, the reports and the jsonl log; each rank prints its
own ``[rank r/W]`` line per epoch, and the ranks meet at a barrier after
each epoch's callbacks.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import torch

def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Training (PyTorch port)")
    p.add_argument("--data_dirs", nargs="+", default=["data/train/audio"],
                   help="dataset roots; add a pseudo dir like the "
                        "reference's data/heng_pseudo (train.py:27-30)")
    p.add_argument("--model", default="conv_1d_time_sliced_with_attention")
    p.add_argument("--experiment", default="210")
    p.add_argument("--output_representation", default="raw",
                   choices=["raw", "spec", "mfcc", "mfcc_and_raw"])
    p.add_argument("--batch_size", type=int, default=384)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--wanted_only", action="store_true", default=True)
    p.add_argument("--all_words", dest="wanted_only", action="store_false")
    p.add_argument("--extend_reversed", action="store_true")
    p.add_argument("--window_size_ms", type=float, default=30.0)
    p.add_argument("--window_stride_ms", type=float, default=10.0)
    p.add_argument("--dct_coefficient_count", type=int, default=80)
    p.add_argument("--num_log_mel_features", type=int, default=60)
    p.add_argument("--silence_percentage", type=float, default=13.0)
    p.add_argument("--unknown_percentage", type=float, default=60.0)
    p.add_argument("--validation_percentage", type=float, default=10.0)
    p.add_argument("--testing_percentage", type=float, default=0.0)
    p.add_argument("--pseudo_frequency", type=float, default=0.6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="bfloat16 = mixed-precision forward/backward "
                        "(f32 master weights); auto = bfloat16 on the "
                        "card, float32 on the CPU")
    p.add_argument("--steps_per_epoch", type=int, default=0)
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="train steps per train_many call (the same "
                        "updates; see Trainer.fit)")
    p.add_argument("--bn_recalibration_batches", type=int, default=0,
                   help="re-estimate BatchNorm statistics over N fresh "
                        "batches before each validation sweep")
    p.add_argument("--resume", default="",
                   help="checkpoint file of the port to resume from")
    p.add_argument("--stream", action="store_true",
                   help="stream the training clips from the files "
                        "(data/prefetch.py); only the validation "
                        "partition and the background bank are staged")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


class _Report:
    """The confusion reports, printed metrics and ``logs_<id>.jsonl``."""

    def __init__(self, report, experiment: str):
        self.report = report
        self.path = f"logs_{experiment}.jsonl"

    def on_epoch_end(self, epoch, state, logs):
        logs.update(self.report.write(epoch, logs["confusion"],
                                      logs["val_loss"]))
        printable = {k: round(v, 4) for k, v in logs.items()
                     if isinstance(v, (int, float))}
        print(f"[ep {epoch:03d}] {printable}")
        with open(self.path, "a") as f:
            f.write(json.dumps(printable) + "\n")
        return None


class _RankLine:
    """Over several ranks: each rank prints its epoch's train loss and
    validation figures (repr, so that ranks compare bit for bit), then
    waits for the others at a barrier, while rank 0 writes."""

    def __init__(self, mesh):
        self.mesh = mesh

    def on_epoch_end(self, epoch, state, logs):
        import torch.distributed as dist

        print(f"[rank {self.mesh.rank}/{self.mesh.size}] epoch {epoch}: "
              f"step={state.step} loss={float(logs['loss'])!r} "
              f"val_loss={float(logs['val_loss'])!r} "
              f"val_acc={float(logs['val_categorical_accuracy'])!r}",
              flush=True)
        dist.barrier(group=self.mesh.group)
        return None


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train; returns ``{"trainer", "state", "val_loss",
    "val_categorical_accuracy"}`` of the final sweep."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        build_device_dataset,
    )
    from speech_recognition_tpu_torch.data.index import build_dataset_index
    from speech_recognition_tpu_torch.labels import (
        get_classes, prepare_words_list,
    )
    from speech_recognition_tpu_torch.parallel.distributed import (
        host_replicated, join_from_env,
    )
    from speech_recognition_tpu_torch.train.checkpoint import (
        BestCheckpoint, PlateauCallback, restore_checkpoint,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer, TrainState
    from speech_recognition_tpu_torch.train.metrics import (
        ConfusionReport, TensorBoardCallback, accuracy,
    )
    from speech_recognition_tpu_torch.train.optim import ReduceLROnPlateau

    device, mesh = join_from_env(args.device)
    rows = mesh.rows(args.batch_size)           # B % W == 0
    main_rank = mesh.rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    classes = get_classes(wanted_only=args.wanted_only,
                          extend_reversed=args.extend_reversed)
    words = prepare_words_list(classes)
    settings = prepare_model_settings(
        label_count=len(words),
        window_size_ms=args.window_size_ms,
        window_stride_ms=args.window_stride_ms,
        dct_coefficient_count=args.dct_coefficient_count,
        num_log_mel_features=args.num_log_mel_features,
        output_representation=args.output_representation)
    say(f"device: {device}" + (f"; {mesh.size} ranks, {rows.stop - rows.start}"
                               f" clips each of a global batch of "
                               f"{args.batch_size}" if mesh.size > 1 else ""))
    say("indexing dataset...")
    index = build_dataset_index(
        data_dirs=args.data_dirs,
        silence_percentage=args.silence_percentage,
        unknown_percentage=args.unknown_percentage,
        wanted_words=classes,
        validation_percentage=args.validation_percentage,
        testing_percentage=args.testing_percentage)
    say(index.summary())
    say("staging the validation partition to device memory..."
        if args.stream else "staging dataset to device memory...")
    dataset = host_replicated(build_device_dataset(
        index, settings, device,
        modes=["validation"] if args.stream else None), mesh)
    trainer = Trainer(
        model_name=args.model, settings=settings, dataset=dataset,
        augment=AugmentConfig(pseudo_frequency=args.pseudo_frequency),
        batch_size=args.batch_size, seed=args.seed,
        compute_dtype=args.compute_dtype, mesh=mesh)
    state = trainer.init_state()
    if args.resume:
        state = restore_checkpoint(args.resume, state)
        # every rank read the file; rank 0's tensors then stand for it
        # (the optimizer's step counts stay on the host, equal by then)
        host_replicated((state.model, [
            t for group in state.optimizer.state.values()
            for t in group.values()
            if torch.is_tensor(t) and t.device == device]), mesh)
        say(f"resumed from {args.resume} at step {state.step}")

    callbacks: List[Any] = [PlateauCallback(ReduceLROnPlateau(
        factor=0.5, patience=4, min_lr=1e-5, mode="max"))]
    tensorboard = None
    if main_rank:
        # class ids map 1:1 onto the words list (unknown words all share
        # id 1)
        report = ConfusionReport(
            int2label=dict(enumerate(words)),
            wanted_words=prepare_words_list(get_classes(wanted_only=True)),
            all_words=words)
        # reference parity: TensorBoard(log_dir='logs_210') (train.py:64)
        tensorboard = TensorBoardCallback(f"logs_{args.experiment}")
        callbacks = [_Report(report, args.experiment), *callbacks,
                     BestCheckpoint(f"checkpoints_{args.experiment}"),
                     tensorboard]
    if mesh.size > 1:
        callbacks.append(_RankLine(mesh))
    steps = args.steps_per_epoch or None
    try:
        if args.stream:
            from speech_recognition_tpu_torch.data.prefetch import (
                HostPrefetchLoader,
            )
            spe = steps or max(
                1, index.set_size("training") // args.batch_size)
            loader = HostPrefetchLoader(
                index.files("training"), index.labels_array("training"),
                index.is_silence_array("training"),
                batch_size=rows.stop - rows.start,
                desired_samples=settings.desired_samples, seed=args.seed,
                device=device, rank=mesh.rank, world=mesh.size)
            with loader:
                for epoch in range(args.epochs):
                    t0 = time.perf_counter()
                    state, h = trainer.fit_streaming(
                        state, loader, spe,
                        steps_per_dispatch=args.steps_per_dispatch)
                    logs: Dict[str, Any] = {k: v[-1] for k, v in h.items()}
                    logs["epoch_time_s"] = time.perf_counter() - t0
                    if args.bn_recalibration_batches:
                        state = trainer.recalibrate_batch_stats_stream(
                            state, loader, args.bn_recalibration_batches)
                    conf, val_loss = trainer.evaluate(state)
                    logs["val_loss"] = val_loss
                    logs["val_categorical_accuracy"] = accuracy(conf)
                    logs["confusion"] = conf
                    for cb in callbacks:
                        result = cb.on_epoch_end(epoch, state, logs)
                        if isinstance(result, TrainState):
                            state = result
        else:
            state, _ = trainer.fit(
                state, epochs=args.epochs, steps_per_epoch=steps,
                callbacks=callbacks,
                bn_recalibration_batches=args.bn_recalibration_batches,
                steps_per_dispatch=args.steps_per_dispatch)
            if args.bn_recalibration_batches:
                state = trainer.recalibrate_batch_stats(
                    state, args.bn_recalibration_batches)
    finally:
        if tensorboard is not None:
            tensorboard.close()
    conf, val_loss = trainer.evaluate(state)
    acc = accuracy(conf)
    line = f"final: val_loss={val_loss:.4f} val_acc={acc:.4f}"
    if mesh.size > 1:
        from speech_recognition_tpu_torch.ops.kernels import (
            decode_augment, sharded,
        )
        line = (f"[rank {mesh.rank}/{mesh.size}] {line} launches: "
                f"decode_augment={decode_augment.LAUNCHES} "
                f"decode_augment_sharded={sharded.LAUNCHES}")
    print(line, flush=True)
    return {"trainer": trainer, "state": state, "val_loss": val_loss,
            "val_categorical_accuracy": acc}


if __name__ == "__main__":
    from speech_recognition_tpu_torch.parallel.distributed import leave

    try:
        main()
    finally:
        leave()
