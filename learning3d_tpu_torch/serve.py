"""Batched inference engine, counterpart of ``learning3d_tpu/serve.py::
InferenceEngine``.

    engine = InferenceEngine(model, batch_size=256)
    logits = engine(points)     # numpy (n, N, 3), any n -> numpy (n, ...)

Inputs of any leading size are split into full ``batch_size`` chunks; the
tail chunk is zero-padded to ``batch_size``, so the model always sees the
same shape, and the padding is stripped from the output. Each chunk makes
one host-to-device copy in and one device-to-host copy out, under
``torch.inference_mode()``. A bf16 output comes back as float32 numpy
(numpy has no bf16). Mesh serving, dict outputs and per-shape CUDA graphs
are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, batch_size: int = 256, *, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = int(batch_size)

    def __call__(self, *inputs):
        """inputs: numpy arrays with a shared leading dimension n. Returns a
        numpy array with leading dimension n."""
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
                out = self.model(*args)[:got]
                if out.dtype == torch.bfloat16:
                    out = out.float()
                pieces.append(out.cpu().numpy())
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=0)
