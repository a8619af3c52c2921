"""Reference-compatibility facade (port of speech_recognition_tpu/compat.py).

Drop-in equivalents of the reference's entry objects, so that code
written against them keeps its shape: ``AudioProcessor``
(input_data.py:159-610) and ``data_gen`` (utils.py:6-53). Underneath is
the port's path: the device-resident bank (``DeviceDataset``), the
augmentation draws from an explicit ``torch.Generator`` applied by the
decode+augment kernel (its plain version for a CPU bank), and the
``Frontend``. The ``sess`` parameters are accepted and ignored.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.config import AugmentConfig, ModelSettings
from speech_recognition_tpu_torch.data.device_bank import (
    DeviceDataset, build_device_dataset,
)
from speech_recognition_tpu_torch.data.index import (
    DatasetIndex, build_dataset_index,
)
from speech_recognition_tpu_torch.ops.augment import (
    augment_batch, draw_augment_params,
)
from speech_recognition_tpu_torch.ops.frontend import Frontend
from speech_recognition_tpu_torch.ops.kernels.decode_augment import (
    decode_augment,
)


class AudioProcessor:
    """Reference-signature data engine (input_data.py:162-175).

    ``model_settings`` may be a ModelSettings dataclass or the reference's
    settings dict (prepare_model_settings output). The bank lives on
    ``device`` (default: the card); training batches draw from a
    ``torch.Generator`` there, seeded with ``seed``.
    """

    def __init__(self, data_dirs: Sequence[str],
                 silence_percentage: float, unknown_percentage: float,
                 wanted_words: Sequence[str],
                 validation_percentage: float, testing_percentage: float,
                 model_settings, output_representation: str = "raw",
                 device: Optional[torch.device] = None, seed: int = 0):
        from speech_recognition_tpu_torch.device import require_cuda

        if isinstance(model_settings, dict):
            model_settings = ModelSettings(
                label_count=model_settings["label_count"],
                sample_rate=model_settings["sample_rate"],
                desired_samples=model_settings["desired_samples"],
                window_size_samples=model_settings["window_size_samples"],
                window_stride_samples=model_settings[
                    "window_stride_samples"],
                spectrogram_length=model_settings["spectrogram_length"],
                dct_coefficient_count=model_settings[
                    "dct_coefficient_count"],
                num_log_mel_features=model_settings.get(
                    "num_log_mel_features", 40),
                output_representation=output_representation,
                fingerprint_size=model_settings.get("fingerprint_size", 0),
            )
        if output_representation not in {"raw", "spec", "mfcc",
                                         "mfcc_and_raw"}:
            raise ValueError(f"output_representation "
                             f"{output_representation!r}")
        self.device = (require_cuda() if device is None
                       else torch.device(device))
        self.output_representation = output_representation
        self.model_settings = model_settings
        self.index: DatasetIndex = build_dataset_index(
            data_dirs=data_dirs,
            silence_percentage=silence_percentage,
            unknown_percentage=unknown_percentage,
            wanted_words=wanted_words,
            validation_percentage=validation_percentage,
            testing_percentage=testing_percentage)
        self.dataset: DeviceDataset = build_device_dataset(
            self.index, model_settings, self.device)
        self.frontend = Frontend(model_settings, "highest")
        self.words_list = self.index.words_list
        self.word_to_index = self.index.word_to_index
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    # -- reference API ------------------------------------------------------

    def set_size(self, mode: str) -> int:
        """input_data.py:383-393."""
        return self.dataset.set_size(mode)

    def summary(self) -> None:
        """input_data.py:591-610."""
        print(self.index.summary())

    def get_data(self, how_many: int, offset: int,
                 background_frequency: float,
                 background_volume_range: float,
                 foreground_frequency: float,
                 foreground_volume_range: float,
                 time_shift_frequency: float,
                 time_shift_range: Sequence[int],
                 mode: str, sess=None,
                 pseudo_frequency: float = 0.0,
                 flip_frequency: float = 0.0,
                 silence_volume_range: float = 0.0,
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched equivalent of input_data.py:395-541.

        Returns (features, one-hot labels) as numpy, with the reference's
        semantics: random draws in training mode (samples and
        augmentation from the processor's generator, applied by the
        decode+augment kernel), deterministic sequential batches with the
        neutral feed otherwise; ``sess`` is ignored.
        """
        del sess
        ds = self.dataset
        cfg = AugmentConfig(
            background_frequency=background_frequency,
            background_volume_range=background_volume_range,
            foreground_frequency=foreground_frequency,
            foreground_volume_range=foreground_volume_range,
            time_shift_frequency=time_shift_frequency,
            time_shift_range=(int(time_shift_range[0]),
                              int(time_shift_range[1])),
            flip_frequency=flip_frequency,
            silence_volume_range=silence_volume_range,
            pseudo_frequency=pseudo_frequency)
        if how_many == -1:
            how_many = ds.set_size(mode)
        if mode == "training":
            g = self.generator
            fids, labels, silence = ds.sample_train_ids(
                g, how_many, pseudo_frequency)
            params = draw_augment_params(g, silence, cfg, ds.background,
                                         how_many, ds.desired_samples)
            bg = (ds.background.flat if ds.background is not None
                  else torch.zeros(ds.desired_samples, device=self.device))
            wav = decode_augment(ds.wav_bank, bg, fids, *params)
        else:
            count = max(0, min(how_many, ds.set_size(mode) - offset))
            fids, labels, silence = ds.eval_ids(mode, offset, count)
            wav = augment_batch(ds.decode(fids), silence)
        feats = self.frontend.features(wav, self.output_representation)
        labels = labels.cpu().numpy()
        onehot = np.zeros((len(labels), self.model_settings.label_count),
                          np.float32)
        onehot[np.arange(onehot.shape[0]), labels] = 1.0
        if self.output_representation == "mfcc_and_raw":
            mfcc, raw = feats
            return [mfcc.cpu().numpy(), raw.cpu().numpy()], onehot
        return feats.cpu().numpy(), onehot

    def get_unprocessed_data(self, how_many: int, model_settings=None,
                             mode: str = "validation",
                             ) -> Tuple[np.ndarray, List[str]]:
        """input_data.py:543-589 (labels as strings, like the reference)."""
        del model_settings
        wav, labels = self.dataset.get_unprocessed_data(mode, how_many)
        names = [self.words_list[i] if i < len(self.words_list) else
                 "_unknown_" for i in labels.cpu().numpy()]
        return wav.cpu().numpy(), names


def data_gen(audio_processor: AudioProcessor, sess=None,
             batch_size: int = 128,
             background_frequency: float = 0.3,
             background_volume_range: float = 0.15,
             foreground_frequency: float = 0.3,
             foreground_volume_range: float = 0.15,
             time_shift_frequency: float = 0.3,
             time_shift_range: Sequence[int] = (-500, 0),
             mode: str = "validation",
             pseudo_frequency: float = 0.33,
             flip_frequency: float = 0.0,
             silence_volume_range: float = 0.3,
             ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite batch generator (parity: utils.py:6-53 incl. the
    non-training neutralization of every knob except silence volume)."""
    del sess
    offset = 0
    if mode != "training":
        background_frequency = 0.0
        background_volume_range = 0.0
        foreground_frequency = 0.0
        foreground_volume_range = 0.0
        pseudo_frequency = 0.0
        time_shift_frequency = 0.0
        time_shift_range = (0, 0)
        flip_frequency = 0.0
    while True:
        x, y = audio_processor.get_data(
            how_many=batch_size,
            offset=0 if mode == "training" else offset,
            background_frequency=background_frequency,
            background_volume_range=background_volume_range,
            foreground_frequency=foreground_frequency,
            foreground_volume_range=foreground_volume_range,
            time_shift_frequency=time_shift_frequency,
            time_shift_range=time_shift_range,
            mode=mode, pseudo_frequency=pseudo_frequency,
            flip_frequency=flip_frequency,
            silence_volume_range=silence_volume_range)
        offset += batch_size
        if offset > audio_processor.set_size(mode) - batch_size:
            offset = 0
        yield x, y
