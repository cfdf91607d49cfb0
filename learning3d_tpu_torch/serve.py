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
key. Mesh serving, ``TemplateRegistrar`` and per-shape CUDA graphs are not
ported yet.
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
