"""Batched inference engine, counterpart of ``learning3d_tpu/serve.py::
InferenceEngine``.

    engine = InferenceEngine(model, batch_size=256)
    logits = engine(points)     # numpy (n, N, 3), any n -> numpy (n, ...)

    result = InferenceEngine(dcp, batch_size=32)(template, source)  # dict

Inputs of any leading size are split into full ``batch_size`` chunks; the
tail chunk is zero-padded to ``batch_size``, so the model always sees the
same shape, and the padding is stripped from the output. Each chunk makes
one host-to-device copy per input and one device-to-host copy per output
(per key of a dict result), under ``torch.inference_mode()``. A bf16
output comes back as float32 numpy (numpy has no bf16). A dict result
stays a dict, each key concatenated across chunks; ``output_key`` picks one
key.

    reg = TemplateRegistrar(dcp, template, batch_size=32)
    result = reg(sources)       # numpy (n, N, 3), any n -> dict

registers many sources against one fixed template, whose encoder pass runs
once. Mesh serving and per-shape CUDA graphs are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device


def _to_numpy(t: torch.Tensor, rows: int) -> np.ndarray:
    t = t[:rows]
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, batch_size: int = 256, *, output_key: str | None = None,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = int(batch_size)
        self.output_key = output_key

    def __call__(self, *inputs):
        """inputs: numpy arrays with a shared leading dimension n. Returns a
        numpy array with leading dimension n, or a dict of them for a model
        that returns a dict (one array if ``output_key`` is set)."""
        inputs = [np.ascontiguousarray(a) for a in inputs]
        n = inputs[0].shape[0]
        if any(a.shape[0] != n for a in inputs):
            raise ValueError("inputs must share the leading (batch) dimension")
        bs = self.batch_size
        pieces = []
        with torch.inference_mode():
            for lo in range(0, n, bs):
                chunk = [a[lo : lo + bs] for a in inputs]
                got = chunk[0].shape[0]
                if got < bs:  # pad the tail to keep the batch shape
                    chunk = [np.concatenate([c, np.zeros((bs - got,) + c.shape[1:], c.dtype)]) for c in chunk]
                args = [torch.from_numpy(c).to(self.device) for c in chunk]
                out = self.model(*args)
                if isinstance(out, dict):
                    pieces.append({key: _to_numpy(val, got) for key, val in out.items()})
                else:
                    pieces.append(_to_numpy(out, got))
        if isinstance(pieces[0], dict):
            out = {key: np.concatenate([p[key] for p in pieces], axis=0) for key in pieces[0]}
            return out if self.output_key is None else out[self.output_key]
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=0)


class TemplateRegistrar:
    """One-template-many-sources registration serving, for a model with
    ``encode()`` / ``register_encoded()`` (DCP, and its int8 clone from
    ``quant.quantize_dcp``). The template's encoder features are computed
    once, here; each chunk of sources is registered against them broadcast
    to the chunk, so a request pays only the sources' encoder, the pointer
    and the head. Chunks are ``batch_size`` sources, the tail zero-padded
    and stripped, as in ``InferenceEngine``; est_* map each source onto the
    template."""

    def __init__(self, model: torch.nn.Module, template, batch_size: int = 32, *, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = int(batch_size)
        t = np.asarray(template, np.float32)
        if t.ndim == 2:
            t = t[None]
        if t.ndim != 3 or t.shape[0] != 1:
            raise ValueError("template must be one (N, 3) cloud")
        self._template = torch.from_numpy(np.ascontiguousarray(t)).to(self.device)
        with torch.inference_mode():
            self._temb = self.model.encode(self._template)  # (1, N, E), cached

    def __call__(self, sources):
        sources = np.asarray(sources, np.float32)
        if sources.ndim == 2:
            sources = sources[None]
        n, bs = sources.shape[0], self.batch_size
        pieces = []
        with torch.inference_mode():
            for lo in range(0, n, bs):
                chunk = sources[lo : lo + bs]
                got = chunk.shape[0]
                if got < bs:  # pad the tail to keep the batch shape
                    chunk = np.concatenate([chunk, np.zeros((bs - got,) + chunk.shape[1:], chunk.dtype)])
                src = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
                out = self.model.register_encoded(self._template.expand(bs, -1, -1), self._temb.expand(bs, -1, -1),
                                                  src)
                pieces.append({key: _to_numpy(val, got) for key, val in out.items()})
        return {key: np.concatenate([p[key] for p in pieces], axis=0) for key in pieces[0]}
