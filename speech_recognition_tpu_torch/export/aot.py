"""Export for the edge (port of speech_recognition_tpu/export/aot.py).

The reference freezes a Keras graph into a ``.pb`` from a decoded
waveform to ``labels_softmax`` (freeze_graph.py:64-81), and serves it on
a Raspberry Pi under 5,000,000 bytes (README.md:14). The JAX package
exports a StableHLO artifact; the port exports a ``torch.export``
archive: a program from a waveform [batch, 16000] float32 to the class
probabilities (frontend, model in eval mode, softmax, and optionally the
32->12 head), with the weights stored in the archive, so that
``load_exported`` runs it with no zoo code.

``weight_dtype='int8'`` stores every large float32 weight per output
channel as int8 and a float32 scale (``quantize_weights_int8``), and
dequantizes it inside the program: weight-only quantization, the
activations and the arithmetic stay float32.

The archive is exported on the CPU and holds no example input, and its
graph no debug metadata (stack traces, module stacks): what it stores
is the program and its tensors. ``load_exported`` moves the program to
the device it is asked for and runs it with TF32 off, as the f32
``Predictor`` does.
"""

from __future__ import annotations

import copy
import io
import os
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from speech_recognition_tpu_torch.labels import get_classes

# node metadata for debugging only; none of it is read to run the program
_DEBUG_META = ("stack_trace", "nn_module_stack", "source_fn_stack",
               "from_node", "torch_fn", "seq_nr")


def map_32_to_12_probs(all_probs: torch.Tensor,
                       extend_reversed: bool = False) -> torch.Tensor:
    """[..., 32/49] probabilities -> [..., 12]: silence kept, unknown =
    the **max** over ``_unknown_`` and every non-wanted class, then a
    softmax (freeze_graph_32_classes.py:55-69)."""
    wanted = get_classes(wanted_only=True)
    all_classes = get_classes(wanted_only=False,
                              extend_reversed=extend_reversed)
    wanted_idx: List[int] = []
    unknown_idx: List[int] = [1]  # _unknown_
    for i, c in enumerate(all_classes):
        (wanted_idx if c in wanted else unknown_idx).append(i + 2)
    silence = all_probs[..., 0:1]
    unknown = all_probs[..., unknown_idx].amax(dim=-1, keepdim=True)
    words = all_probs[..., wanted_idx]
    return torch.softmax(torch.cat([silence, unknown, words], dim=-1),
                         dim=-1)


class _InferenceProgram(nn.Module):
    """Waveform [B, T] -> probabilities [B, C]: ``frontend.features``,
    the model in eval mode, a softmax, and the 32->12 head if asked."""

    def __init__(self, model: nn.Module, frontend, representation: str,
                 map_to_12: bool = False, extend_reversed: bool = False):
        super().__init__()
        self.model = model.eval()
        self.frontend = frontend
        self.representation = representation
        self.map_to_12 = map_to_12
        self.extend_reversed = extend_reversed

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.frontend.features(wav, self.representation)
        probs = torch.softmax(self.model(x), dim=-1)
        if self.map_to_12:
            probs = map_32_to_12_probs(probs, self.extend_reversed)
        return probs


def make_inference_fn(model: nn.Module, frontend, representation: str,
                      map_to_12: bool = False,
                      extend_reversed: bool = False) -> _InferenceProgram:
    """The inference program over ``model`` (eval mode; the JAX
    function's closure over its variables)."""
    return _InferenceProgram(model, frontend, representation, map_to_12,
                            extend_reversed).eval()


QuantizedLeaf = Tuple[torch.Tensor, Optional[torch.Tensor]]


def quantize_weights_int8(state_dict: Dict[str, torch.Tensor],
                          min_size: int = 256) -> Dict[str, QuantizedLeaf]:
    """Per-output-channel symmetric int8 quantization of a state_dict.

    Every float32 tensor with ndim >= 2 and at least ``min_size``
    elements (conv, depthwise, dense and GRU kernels) becomes ``(q,
    scale)``: q int8 in [-127, 127], scale float32 of shape [out, 1, ...]
    with ``scale = max |w| / 127`` over the channel (1 for an all-zero
    channel) and ``q = round(w / scale)``, half to even. The channel is
    torch's dim 0, the output axis of every kernel, which is the last
    axis of its flax layout (JAX: aot.py:65-91). Everything else (BN
    vectors, biases) stays as it is, ``(w, None)``.
    """
    out: Dict[str, QuantizedLeaf] = {}
    for name, w in state_dict.items():
        w = w.detach().cpu()
        if w.ndim >= 2 and w.numel() >= min_size \
                and w.dtype == torch.float32:
            amax = w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0,
                                torch.ones_like(amax))
            q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
            out[name] = (q, scale)
        else:
            out[name] = (w, None)
    return out


class _Int8Program(nn.Module):
    """An ``_InferenceProgram`` whose quantized weights are int8 buffers
    and scales, dequantized (``q.float() * scale``) inside ``forward``;
    the float32 originals are removed from the model."""

    def __init__(self, program: _InferenceProgram, min_size: int = 256):
        super().__init__()
        self.program = program
        self.names: List[Tuple[str, str, str]] = []
        leaves = quantize_weights_int8(program.model.state_dict(), min_size)
        for i, (name, (q, scale)) in enumerate(leaves.items()):
            if scale is None:
                continue
            owner, _, leaf = name.rpartition(".")
            delattr(program.model.get_submodule(owner), leaf)
            self.register_buffer(f"q{i}", q)
            self.register_buffer(f"scale{i}", scale)
            self.names.append((f"model.{name}", f"q{i}", f"scale{i}"))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        weights = {name: getattr(self, q).float() * getattr(self, s)
                   for name, q, s in self.names}
        return torch.func.functional_call(self.program, weights, (wav,),
                                          strict=False)


def _own_storage(module: nn.Module) -> nn.Module:
    """Every parameter and buffer a contiguous tensor of its own (a view
    of a larger storage would be saved with the whole storage)."""
    for m in module.modules():
        for group in (m._parameters, m._buffers):
            for k, t in group.items():
                if t is not None:
                    owned = t.detach().contiguous().clone()
                    group[k] = (nn.Parameter(owned, t.requires_grad)
                                if isinstance(t, nn.Parameter) else owned)
    return module


def export_inference(model: nn.Module, frontend, representation: str,
                     desired_samples: int = 16000, batch_size: int = 1,
                     map_to_12: bool = False, extend_reversed: bool = False,
                     weight_dtype: str = "float32") -> bytes:
    """The bytes of a ``torch.export`` archive of the inference program
    for a waveform [batch_size, desired_samples] float32, with the
    weights stored in it (as float32, or for ``'int8'`` as
    ``quantize_weights_int8`` gives them). ``frontend`` must be a CPU
    ``Frontend`` at 'highest'; ``model`` is copied to the CPU and left as
    it is."""
    if weight_dtype not in ("float32", "int8"):
        raise ValueError(f"unsupported weight_dtype {weight_dtype!r}")
    model = _own_storage(copy.deepcopy(model).float().cpu())
    program: nn.Module = make_inference_fn(model, frontend, representation,
                                           map_to_12, extend_reversed)
    if weight_dtype == "int8":
        program = _Int8Program(program)
    wav = torch.zeros((batch_size, desired_samples), dtype=torch.float32)
    with torch.no_grad():
        # one eager call first: the frontend's matrices are cached per
        # geometry and device at their first use, and that use must not
        # be inside the trace (it would cache the trace's fake tensors)
        program.eval()(wav)
        ep = torch.export.export(program, (wav,))
    ep._example_inputs = None
    for node in ep.graph.nodes:
        for key in _DEBUG_META:
            node.meta.pop(key, None)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def save_exported(path: str, artifact: bytes) -> None:
    with open(path, "wb") as f:
        f.write(artifact)


def load_exported(path_or_bytes: Union[str, os.PathLike, bytes],
                  device: Optional[torch.device] = None,
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load an archive; returns ``fn(wav [B, T]) -> probs [B, C]`` on
    ``device`` (default: the card), which takes a tensor or a numpy
    array and runs with TF32 off and no autograd."""
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.infer.tta import _no_tf32

    device = require_cuda() if device is None else torch.device(device)
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    else:
        data = path_or_bytes
    ep = torch.export.load(io.BytesIO(data))
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, device)
    program = ep.module()

    def fn(wav: Union[torch.Tensor, np.ndarray]) -> torch.Tensor:
        wav = torch.as_tensor(wav).to(device, torch.float32)
        with torch.no_grad(), _no_tf32():
            return program(wav)

    return fn
