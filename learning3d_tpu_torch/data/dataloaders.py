"""Host-side datasets (numpy), the port's own copy of the classification
half of ``learning3d_tpu/data/dataloaders.py``: ``SHAPE_NAMES``, the
procedural ``SyntheticModelNet40`` (the stand-in for ModelNet40 where the
archive cannot be downloaded) and ``ClassificationData``. Items are numpy
arrays, identical to the JAX package's bit for bit; batching for the device
loop lives in ``device_pipeline``. The HDF5-backed ModelNet40 and the
registration, segmentation and flow datasets are not ported yet.
"""

from __future__ import annotations

import numpy as np

SHAPE_NAMES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant", "radio",
    "range_hood", "sink", "sofa", "stairs", "stool", "table", "tent",
    "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]


class SyntheticModelNet40:
    """Procedural stand-in for ModelNet40 when the archive is unavailable
    (zero-egress environments). 40 classes of parametric primitives with
    class-dependent shape statistics — learnable, deterministic per index,
    same item contract as ModelNet40Data.

    ``param_jitter`` (default off) perturbs each ITEM's aspect-ratio
    parameters by a uniform relative factor, adding true intra-class
    shape diversity — the knob that keeps high-capacity classifiers
    (CurveNet) from memorizing a small ``size``. The class-keyed
    symmetry-breaking bumps stay deterministic per label either way, so
    registration ground truth remains identifiable.
    """

    # Dataset-version tag recorded in the Trainer's meta.json: metrics from
    # different versions are not comparable. 1 = bare primitives; 2 = with
    # class-keyed symmetry-breaking radial bumps; 2h = ``hard=True``:
    # classes aliased into groups of 4 that share every global shape
    # statistic, the class living only in label-keyed high-frequency surface
    # corrugations near the noise floor. param_jitter, a non-default size,
    # normals and num_points are appended by ``version_tag``.
    VERSION = 2

    def __init__(self, train=True, num_points=1024, size=2048, num_classes=40, seed=0,
                 unseen=False, param_jitter=0.0, use_normals=False, hard=False,
                 detail_amp=0.04, noise=None):
        self.use_normals = bool(use_normals)
        # items are deterministic per index (rng seeded by index alone), so
        # the PCA normal estimation — the one expensive per-item step —
        # is cached. ~50 MB at the default size/num_points.
        self._cache: dict = {}
        self.num_points = num_points
        self.size = size
        self.num_classes = num_classes
        self.seed = seed + (0 if train else 1_000_003)
        self.param_jitter = float(param_jitter)
        self.hard = bool(hard)
        self.detail_amp = float(detail_amp)
        # hard mode defaults to a noise floor just under the corrugation
        # amplitude — the detail is detectable from neighborhoods (local
        # models can average it out) but not from single points
        self.noise = float(noise) if noise is not None else (0.025 if hard else 0.02)
        self.shapes = SHAPE_NAMES[:num_classes]
        # unseen split: restrict the label range like the reference's flag
        self.label_offset = 0 if (not unseen or train) else num_classes // 2
        self.label_range = num_classes // 2 if unseen else num_classes

    def version_tag(self):
        tag = f"synthetic-v{self.VERSION}"
        if self.hard:
            # h2 = the 2.0-4.5 corrugation band
            tag += f"h2+amp{self.detail_amp:g}+noise{self.noise:g}"
        if self.param_jitter:
            tag += f"+jitter{self.param_jitter:g}"
        if self.size != 2048:
            tag += f"+size{self.size}"
        if self.use_normals:
            tag += "+normals"
        if self.num_points != 1024:
            tag += f"+pts{self.num_points}"
        return tag

    def __len__(self):
        return self.size

    def _make(self, rng, label):
        n = self.num_points
        if self.hard:
            # hard classification mode: EVERY global shape statistic is
            # keyed by the alias GROUP (4 consecutive labels share
            # primitive kind, aspect ratios, and the large radial bumps);
            # only the high-frequency corrugations below carry the label
            shape_key = label // 4
            n_keys = max(self.num_classes // 4, 1)
        else:
            shape_key = label
            n_keys = self.num_classes
        kind = shape_key % 4
        u = rng.random(n).astype(np.float32)
        v = rng.random(n).astype(np.float32)
        # shape-key-dependent aspect ratios make shapes separable
        a = 0.3 + 0.7 * ((shape_key * 37 % n_keys) / n_keys)
        b = 0.3 + 0.7 * ((shape_key * 17 % n_keys) / n_keys)
        if self.param_jitter:
            # per-ITEM relative jitter of the shape parameters (rng is the
            # per-index generator, so deterministic per item): intra-class
            # diversity for the heavy classifiers. Bounded so classes stay
            # separable (the a/b class grid step is ~0.018).
            a *= 1.0 + self.param_jitter * (2.0 * rng.random() - 1.0)
            b *= 1.0 + self.param_jitter * (2.0 * rng.random() - 1.0)
        if kind == 0:  # ellipsoid surface
            theta, phi = 2 * np.pi * u, np.arccos(2 * v - 1)
            pts = np.stack(
                [a * np.sin(phi) * np.cos(theta), b * np.sin(phi) * np.sin(theta), np.cos(phi)], -1
            )
        elif kind == 1:  # box surface
            face = rng.integers(0, 6, n)
            pts = rng.random((n, 3)).astype(np.float32) * 2 - 1
            pts[np.arange(n), face % 3] = np.where(face < 3, a, -b)
        elif kind == 2:  # cylinder
            theta = 2 * np.pi * u
            pts = np.stack([a * np.cos(theta), a * np.sin(theta), 2 * b * (v - 0.5)], -1)
        else:  # cone
            h = v
            theta = 2 * np.pi * u
            r = a * (1 - h)
            pts = np.stack([r * np.cos(theta), r * np.sin(theta), b * (2 * h - 1)], -1)
        pts = pts.astype(np.float32)
        # Break the primitives' rotational/reflective self-symmetry with a
        # few class-keyed radial bumps at generic directions (deterministic
        # per label), so that no rotation maps a shape onto itself, as on
        # real ModelNet40 objects.
        crng = np.random.default_rng(1_000_000_007 + 31 * shape_key)
        centers = crng.standard_normal((3, 3)).astype(np.float32)
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
        amps = (0.25 + 0.15 * crng.random(3)).astype(np.float32)
        widths = (0.25 + 0.2 * crng.random(3)).astype(np.float32)
        radial = pts / (np.linalg.norm(pts, axis=1, keepdims=True) + 1e-6)
        bump = np.zeros((pts.shape[0], 1), np.float32)
        for c, amp, w in zip(centers, amps, widths):
            d2 = np.sum((radial - c) ** 2, -1, keepdims=True)
            bump += amp * np.exp(-d2 / w)
        pts += bump.astype(np.float32) * radial
        if self.hard:
            # Label-keyed angular corrugations of 2.0-4.5 cycles, the only
            # class signal in hard mode, at the noise floor: recoverable
            # from a point's neighborhood, not from the point alone.
            drng = np.random.default_rng(777_000_001 + 101 * label)
            wave = np.zeros((pts.shape[0], 1), np.float32)
            for _ in range(3):
                d = drng.standard_normal(3).astype(np.float32)
                d /= np.linalg.norm(d) + 1e-9
                freq = 2.0 + 2.5 * drng.random()
                phase = 2 * np.pi * drng.random()
                camp = 0.7 + 0.6 * drng.random()
                wave += (camp / 3.0) * np.cos(
                    2 * np.pi * freq * (radial @ d[:, None]) + phase
                ).astype(np.float32)
            pts += self.detail_amp * wave * radial
        pts += self.noise * rng.standard_normal(pts.shape).astype(np.float32)
        # normalize to unit sphere like ModelNet40 preprocessing
        pts -= pts.mean(0, keepdims=True)
        pts /= np.abs(pts).max() + 1e-6
        if self.use_normals:
            # ModelNet40's .h5 files carry per-point surface normals
            # (ModelNet40Data use_normals=True concatenates them to
            # (N, 6)); the procedural stand-in estimates them by local
            # PCA — smallest-eigenvector of the k-NN covariance, oriented
            # away from the centroid — the standard mesh-free estimator.
            # Deterministic per item (pure function of pts).
            return np.concatenate([pts, estimate_normals_pca(pts)], -1)
        return pts

    def __getitem__(self, idx):
        label = idx % self.label_range + self.label_offset
        if self.use_normals and idx in self._cache:
            return self._cache[idx], int(label)
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        item = self._make(rng, label)
        if self.use_normals:
            self._cache[idx] = item
        return item, int(label)

    def get_shape(self, label):
        return self.shapes[int(label)]


class ClassificationData:
    """Thin delegating wrapper (reference dataloaders.py:229-247)."""

    def __init__(self, data_class):
        self.data_class = data_class

    def __len__(self):
        return len(self.data_class)

    def __getitem__(self, idx):
        return self.data_class[idx]

    def get_shape(self, label):
        return self.data_class.get_shape(label)


def estimate_normals_pca(pts, k=16):
    """Per-point surface normals from local PCA: smallest eigenvector of
    each point's k-NN covariance, sign-oriented away from the centroid.
    pts (N, 3) float32 -> (N, 3) unit normals. Host-side, deterministic."""
    n = pts.shape[0]
    k = min(k, n)
    d = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, -1)
    idx = np.argpartition(d, k - 1, axis=1)[:, :k]
    nbrs = pts[idx]  # (N, k, 3)
    nbrs = nbrs - nbrs.mean(1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", nbrs, nbrs)
    _, vecs = np.linalg.eigh(cov)  # ascending eigenvalues
    normals = vecs[:, :, 0]
    outward = pts - pts.mean(0, keepdims=True)
    sign = np.sign(np.sum(normals * outward, -1, keepdims=True))
    sign[sign == 0] = 1.0
    return (normals * sign).astype(np.float32)
