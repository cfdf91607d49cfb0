"""Host-side datasets (numpy), the port's own copy of parts of
``learning3d_tpu/data/dataloaders.py``: ``SHAPE_NAMES``, the procedural
``SyntheticModelNet40`` (the stand-in for ModelNet40 where the archive
cannot be downloaded), ``ClassificationData``, and ``RegistrationData`` with
its pair synthesis (per-algorithm transforms, partial crops, jitter), and
the scene-flow sets ``SyntheticSceneflow``, ``SceneflowDataset`` (the
FlyingThings3D npz archive, read from ``root`` or ``$LEARNING3D_DATA``,
else ``~/.learning3d_tpu/data``, as the JAX package reads it) and
``FlowData``, and the part-segmentation sets ``SyntheticPartSegmentation``
and ``SegmentationData``. Items are numpy arrays, identical to the JAX
package's bit for bit (DeepGMR's RRI features, from the port's own
``ops.geometry.get_rri``, to float32 rounding); batching for the device loop
lives in ``device_pipeline``. ``ModelNet40Data`` reads the HDF5 archive
(``h5py``, imported in its constructor) from ``root_dir`` or the same data
directory; ``download_modelnet40`` fetches it, and ``create_random_transform``
draws the reference's random 7-vector pose.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

_MODELNET_URL = "https://shapenet.cs.stanford.edu/media/modelnet40_ply_hdf5_2048.zip"
_DATA_DIR = Path(os.environ.get("LEARNING3D_DATA", Path.home() / ".learning3d_tpu" / "data"))

SHAPE_NAMES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant", "radio",
    "range_hood", "sink", "sofa", "stairs", "stool", "table", "tent",
    "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]


def create_random_transform(rng=None, max_rotation_deg=45.0, max_translation=1.0, dtype=np.float32):
    """A random 7-vector pose [quaternion (w, x, y, z), translation], the
    reference's public helper (data_utils/dataloaders.py:52-61): xyz Euler
    angles uniform in +-max_rotation_deg, a translation uniform in
    +-max_translation, the quaternion by ``ops.quaternion.euler_to_quaternion``
    in float32. ``rng`` is a np.random.Generator (a fresh one if omitted) and
    the draws are the JAX package's. -> (1, 7) numpy."""
    import torch

    from learning3d_tpu_torch.ops.quaternion import euler_to_quaternion

    rng = np.random.default_rng() if rng is None else rng
    max_rotation = deg_to_rad(max_rotation_deg)
    rot = rng.uniform(-max_rotation, max_rotation, (1, 3))
    trans = rng.uniform(-max_translation, max_translation, (1, 3))
    quat = euler_to_quaternion(torch.from_numpy(rot.astype(np.float32)), "xyz").numpy()
    return np.concatenate([quat, trans], axis=1).astype(dtype)


def download_modelnet40(root: str | os.PathLike | None = None) -> Path:
    """Download and unzip modelnet40_ply_hdf5_2048 under ``root`` (the data
    directory by default; reference dataloaders.py:19-29). Needs network
    access and raises otherwise; an existing copy is returned as it is."""
    import urllib.request
    import zipfile

    root = Path(root or _DATA_DIR)
    target = root / "modelnet40_ply_hdf5_2048"
    if target.exists():
        return target
    root.mkdir(parents=True, exist_ok=True)
    zpath = root / "modelnet40.zip"
    try:
        urllib.request.urlretrieve(_MODELNET_URL, zpath)
    except Exception as e:
        raise RuntimeError(
            f"could not download ModelNet40 ({e}); place the extracted "
            f"modelnet40_ply_hdf5_2048 directory under {root} or use "
            "SyntheticModelNet40 for offline runs"
        ) from e
    with zipfile.ZipFile(zpath) as z:
        z.extractall(root)
    zpath.unlink()
    return target


class ModelNet40Data:
    """HDF5-backed ModelNet40 (reference dataloaders.py:184-226): the
    ``ply_data_{train,test}*.h5`` files of ``<root_dir>/modelnet40_ply_hdf5_2048``
    in name order, each item (the first ``num_points`` points, with the
    normals as channels 3-5 for ``use_normals``, optionally permuted by
    ``rng`` first, label). ``unseen`` keeps the first 20 classes for
    training and the last 20 for testing. Where the directory is missing it
    is downloaded if ``download``, else ``FileNotFoundError`` is raised."""

    def __init__(self, train: bool = True, num_points: int = 1024, download: bool = True,
                 root_dir: str | None = None, randomize_data: bool = False, use_normals: bool = False,
                 unseen: bool = False, rng: np.random.Generator | None = None):
        import h5py

        root = Path(root_dir or _DATA_DIR) / "modelnet40_ply_hdf5_2048"
        if not root.exists() and download:
            root = download_modelnet40(root_dir)
        split = "train" if train else "test"
        files = sorted(glob.glob(str(root / f"ply_data_{split}*.h5")))
        if not files:
            raise FileNotFoundError(f"no ModelNet40 h5 files under {root}")
        pts, normals, labels = [], [], []
        for f in files:
            with h5py.File(f, "r") as h:
                pts.append(h["data"][:].astype(np.float32))
                labels.append(h["label"][:].astype(np.int64))
                if use_normals:
                    normals.append(h["normal"][:].astype(np.float32))
        self.data = np.concatenate(pts, 0)
        if use_normals:
            self.data = np.concatenate([self.data, np.concatenate(normals, 0)], -1)
        self.labels = np.concatenate(labels, 0).reshape(-1)
        if unseen:
            keep = self.labels < 20 if train else self.labels >= 20
            self.data = self.data[keep]
            self.labels = self.labels[keep]
        self.num_points = num_points
        self.randomize_data = randomize_data
        self.rng = rng or np.random.default_rng(0)
        self.shapes = SHAPE_NAMES

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, idx):
        pts = self.data[idx]
        if self.randomize_data:
            pts = pts[self.rng.permutation(pts.shape[0])]
        return pts[: self.num_points].copy(), int(self.labels[idx])

    def get_shape(self, label):
        return self.shapes[int(label)]


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


def deg_to_rad(deg):
    return np.pi / 180.0 * deg


def jitter_pointcloud(pointcloud, sigma=0.04, clip=0.05, rng=None):
    """The reference's noise model: sigma is itself scaled by a uniform draw
    per call."""
    rng = rng or np.random.default_rng()
    sigma = sigma * rng.random()
    noise = np.clip(sigma * rng.standard_normal(pointcloud.shape), -clip, clip)
    return (pointcloud + noise).astype(np.float32)


def farthest_subsample_points(pointcloud, num_subsampled_points=768, rng=None):
    """Keep the ``num_subsampled_points`` nearest to a random far-away pivot.
    Returns (subsampled, gt_mask)."""
    rng = rng or np.random.default_rng()
    n = pointcloud.shape[0]
    pivot = rng.random((1, 3)) + np.array([[500.0, 500.0, 500.0]]) * rng.choice([1, -1])
    d = np.sum((pointcloud[:, :3] - pivot) ** 2, -1)
    idx = np.argsort(d)[:num_subsampled_points]
    mask = np.zeros(n, dtype=np.float32)
    mask[idx] = 1
    return pointcloud[idx], mask


def uniform_2_sphere(rng=None):
    rng = rng or np.random.default_rng()
    phi = rng.uniform(0.0, 2 * np.pi)
    cos_theta = rng.uniform(-1.0, 1.0)
    theta = np.arccos(cos_theta)
    return np.array(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)],
        dtype=np.float32,
    )


def planar_crop(points, p_keep=0.7, rng=None):
    """Crop by a random plane, keeping the top ``p_keep`` share of the
    points. Returns (points, kept_indices)."""
    rng = rng or np.random.default_rng()
    normal = uniform_2_sphere(rng)
    centered = points[:, :3] - points[:, :3].mean(0, keepdims=True)
    d = centered @ normal
    mask = d > np.percentile(d, (1.0 - p_keep) * 100)
    return points[mask, :3], np.nonzero(mask)[0]


def get_rri_numpy(pts, k):
    """DeepGMR's RRI features of one centred cloud on the host: pts (N, 3)
    -> (N, 4k) float32, by the port's ``ops.geometry.get_rri`` on a CPU
    tensor."""
    import torch

    from learning3d_tpu_torch.ops.geometry import get_rri

    return get_rri(torch.from_numpy(np.ascontiguousarray(pts, dtype=np.float32)[None]), k)[0].numpy()


class RegistrationData:
    """Per-algorithm registration pair synthesis over a classification
    dataset: items (template, source, igt), igt (4, 4) mapping template ->
    source (with ``additional_params["use_masknet"]`` the masks of the
    partial clouds follow).

    Transform modes: "twist" (PointNetLK, RPMNet: an se(3) exponential of a
    random direction scaled by up to 0.8), "euler_pm" (PCRNet, iPCRNet: XYZ
    Euler angles in +-45 degrees), "euler_pos" (DCP, PRNet: zyx Euler angles
    in [0, 45] degrees; DeepGMR: [0, 90]), each with a uniform translation
    in +-1 for the Euler modes. Every draw comes from one numpy generator
    seeded by (seed, index, epoch), so an item is a function of those and of
    the difficulty. ``set_epoch`` gives fresh pairs per training epoch (not
    for the PCRNet family, which keeps one transform per index);
    ``set_difficulty`` scales the rotation and translation draws (the
    Trainer's curriculum). DeepGMR with ``additional_params
    ["nearest_neighbors"]`` k > 0 appends each cloud's RRI features (4k
    channels, of the cloud centred) to its points."""

    ALGORITHMS = ("PCRNet", "PointNetLK", "DCP", "PRNet", "iPCRNet", "RPMNet", "DeepGMR")

    def __init__(self, algorithm="iPCRNet", data_class=None, partial_source=False, partial_template=False,
                 noise=False, additional_params=None, seed=0):
        if algorithm not in self.ALGORITHMS:
            raise ValueError(f"Algorithm {algorithm} not available for registration.")
        self.algorithm = algorithm
        self.data_class = data_class
        self.partial_source = partial_source
        self.partial_template = partial_template
        self.noise = noise
        self.additional_params = additional_params or {}
        self.seed = seed
        self.use_rri = algorithm == "DeepGMR" and self.additional_params.get("nearest_neighbors", 0) > 0
        self.resample_per_epoch = algorithm not in ("PCRNet", "iPCRNet")
        self._epoch = 0
        self._difficulty = 1.0
        if algorithm in ("PCRNet", "iPCRNet"):
            self.mode, self.angle_range, self.translation_range = "euler_pm", 45.0, 1.0
        elif algorithm in ("PointNetLK", "RPMNet"):
            self.mode, self.mag = "twist", 0.8
        elif algorithm in ("DCP", "PRNet"):
            self.mode, self.angle_range, self.translation_range = "euler_pos", 45.0, 1.0
        else:  # DeepGMR
            self.mode, self.angle_range, self.translation_range = "euler_pos", 90.0, 1.0

    def __len__(self):
        return len(self.data_class)

    def set_epoch(self, epoch):
        """Advance the per-epoch transform stream (a no-op for the PCRNet
        family, which keeps its transform per index)."""
        self._epoch = int(epoch) if self.resample_per_epoch else 0

    def set_difficulty(self, scale):
        """Scale the rotation and translation draws by ``scale``, clipped to
        [0, 1]; 1.0 is the full per-algorithm distribution."""
        self._difficulty = float(min(max(scale, 0.0), 1.0))

    def _sample_transform(self, rng):
        from scipy.spatial.transform import Rotation

        s = self._difficulty
        if self.mode == "twist":
            x = rng.standard_normal(6)
            x = x / np.linalg.norm(x) * (s * self.mag * rng.random())
            w, v = x[:3], x[3:]
            R = Rotation.from_rotvec(w).as_matrix()
            t_norm = np.linalg.norm(w)
            W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
            if t_norm < 1e-8:
                V = np.eye(3)
            else:  # the V matrix of the se(3) exponential
                V = (np.eye(3) + (1 - np.cos(t_norm)) / t_norm**2 * W
                     + (t_norm - np.sin(t_norm)) / t_norm**3 * (W @ W))
            t = V @ v
        elif self.mode == "euler_pm":
            mr = deg_to_rad(self.angle_range)
            e = s * rng.uniform(-mr, mr, 3)
            R = Rotation.from_euler("XYZ", e).as_matrix()
            t = s * rng.uniform(-self.translation_range, self.translation_range, 3)
        else:  # euler_pos
            mr = deg_to_rad(self.angle_range)
            e = s * rng.uniform(0, mr, 3)
            R = Rotation.from_euler("zyx", e).as_matrix()
            t = s * rng.uniform(-self.translation_range, self.translation_range, 3)
        igt = np.eye(4, dtype=np.float32)
        igt[:3, :3] = R
        igt[:3, 3] = t
        return igt

    def __getitem__(self, index):
        template, _ = self.data_class[index]
        template = np.asarray(template, dtype=np.float32)
        rng = np.random.default_rng(self.seed * 1_000_003 + index + self._epoch * 7_777_777)
        igt = self._sample_transform(rng)
        xyz = template[:, :3]
        source = (xyz @ igt[:3, :3].T + igt[:3, 3]).astype(np.float32)
        if template.shape[1] == 6:  # normals rotate too
            source = np.concatenate([source, (template[:, 3:6] @ igt[:3, :3].T).astype(np.float32)], -1)

        template_mask = source_mask = None
        if self.additional_params.get("partial_point_cloud_method") == "planar_crop":
            source, idx_s = planar_crop(source, rng=rng)
            template, idx_t = planar_crop(template, rng=rng)
            inter = np.intersect1d(idx_s, idx_t)
            template_mask = np.isin(idx_t, inter).astype(np.float32)
            source_mask = np.isin(idx_s, inter).astype(np.float32)
        else:
            if self.partial_source:
                source, source_mask = farthest_subsample_points(source, rng=rng)
            if self.partial_template:
                template, template_mask = farthest_subsample_points(template, rng=rng)

        if self.noise:
            source = jitter_pointcloud(source, rng=rng)

        if self.use_rri:
            k = self.additional_params["nearest_neighbors"]
            template = np.concatenate([template, get_rri_numpy(template - template.mean(0), k)], 1)
            source = np.concatenate([source, get_rri_numpy(source - source.mean(0), k)], 1)

        if self.additional_params.get("use_masknet", False):
            extras = [m for m in (template_mask, source_mask) if m is not None]
            return (template, source, igt, *extras)
        return template, source, igt


class SyntheticPartSegmentation:
    """Procedural part segmentation: each item is a shape of 2 to
    ``num_parts`` primitive parts (sphere, cylinder, box surfaces) stacked
    along z, jittered, centred and scaled into the unit cube, with a part
    label a point -> (points (N, 3) f32, seg (N,) int32), deterministic per
    index."""

    def __init__(self, train=True, num_points=1024, size=512, num_parts=4, seed=0):
        self.num_points = num_points
        self.size = size
        self.num_parts = num_parts
        self.seed = seed + (0 if train else 1_000_003)

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 2654435761 + idx)
        k = int(rng.integers(2, self.num_parts + 1))
        counts = np.full(k, self.num_points // k)
        counts[: self.num_points - counts.sum()] += 1
        pts, labels = [], []
        for part in range(k):
            n = counts[part]
            u, v = rng.random(n, np.float32), rng.random(n, np.float32)
            kind = part % 3
            if kind == 0:  # sphere
                th, ph = 2 * np.pi * u, np.arccos(2 * v - 1)
                p = 0.4 * np.stack([np.sin(ph) * np.cos(th), np.sin(ph) * np.sin(th), np.cos(ph)], -1)
            elif kind == 1:  # cylinder
                th = 2 * np.pi * u
                p = np.stack([0.25 * np.cos(th), 0.25 * np.sin(th), 0.6 * (v - 0.5)], -1)
            else:  # box
                face = rng.integers(0, 6, n)
                p = rng.random((n, 3), np.float32) * 0.6 - 0.3
                p[np.arange(n), face % 3] = np.where(face < 3, 0.3, -0.3)
            p = p + np.array([0.0, 0.0, 0.9 * part - 0.45 * (k - 1)], np.float32)
            pts.append(p.astype(np.float32))
            labels.append(np.full(n, part, np.int32))
        pts = np.concatenate(pts)
        labels = np.concatenate(labels)
        pts += 0.01 * rng.standard_normal(pts.shape).astype(np.float32)
        pts -= pts.mean(0, keepdims=True)
        pts /= np.abs(pts).max() + 1e-6
        order = rng.permutation(self.num_points)
        return pts[order], labels[order]


class SegmentationData:
    """Per-point labelled dataset wrapper over a data_class yielding (points
    (N, 3), seg_labels (N,)), ``SyntheticPartSegmentation()`` by default."""

    def __init__(self, data_class=None):
        self.data_class = data_class if data_class is not None else SyntheticPartSegmentation()

    def __len__(self):
        return len(self.data_class)

    def __getitem__(self, idx):
        return self.data_class[idx]


class FlowData:
    """Scene-flow dataset wrapper over any data_class yielding (pos1, pos2,
    color1, color2, flow, mask1) items, SceneflowDataset by default and
    SyntheticSceneflow where the npz archive is absent."""

    def __init__(self, data_class=None, npoints=1024, partition="train"):
        if data_class is None:
            data_class = SceneflowDataset(npoints=npoints, partition=partition)
            if len(data_class) == 0:
                data_class = SyntheticSceneflow(npoints=npoints)
        self.data_class = data_class

    def __len__(self):
        return len(self.data_class)

    def __getitem__(self, idx):
        return self.data_class[idx]


class SyntheticSceneflow:
    """Procedural scene-flow pairs: frame 1 is a SyntheticModelNet40 cloud,
    frame 2 a small rigid motion of it plus a smooth non-rigid warp, the
    flow the exact displacement; colors are zeros and the mask ones. Items
    (pos1, pos2, color1, color2, flow, mask1), deterministic per index."""

    def __init__(self, npoints=1024, size=256, seed=0):
        self.npoints = npoints
        self.size = size
        self.seed = seed
        self.base = SyntheticModelNet40(num_points=npoints, size=size, seed=seed)

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        from scipy.spatial.transform import Rotation

        rng = np.random.default_rng(self.seed * 7_654_321 + idx)
        pos1, _ = self.base[idx]
        w = 0.1 * rng.standard_normal(3)
        t = 0.1 * rng.standard_normal(3)
        R = Rotation.from_rotvec(w).as_matrix().astype(np.float32)
        warp = 0.05 * np.sin(pos1 @ rng.standard_normal((3, 3)).astype(np.float32))
        pos2 = pos1 @ R.T + t.astype(np.float32) + warp
        flow = (pos2 - pos1).astype(np.float32)
        color1 = np.zeros_like(pos1)
        color2 = np.zeros_like(pos2)
        mask1 = np.ones(self.npoints, np.float32)
        return pos1, pos2.astype(np.float32), color1, color2, flow, mask1


class SceneflowDataset:
    """The FlyingThings3D-processed npz archive (``TRAIN*.npz`` /
    ``TEST*.npz`` under ``root``, the one sample the reference excludes left
    out). A train item draws npoints of each frame without replacement from
    the dataset's own ``np.random.default_rng(seed)``, a test item takes the
    first npoints; both frames are centered on frame 1's mean. Empty where
    the archive is absent."""

    def __init__(self, npoints=1024, root=None, partition="train", seed=0):
        self.npoints = npoints
        self.partition = partition
        root = root or str(_DATA_DIR / "data_processed_maxcut_35_20k_2k_8192")
        pattern = os.path.join(root, "TRAIN*.npz" if partition == "train" else "TEST*.npz")
        self.datapath = [d for d in sorted(glob.glob(pattern)) if "TRAIN_C_0140_left_0006-0" not in d]
        self.cache = {}
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index):
        if index in self.cache:
            pos1, pos2, color1, color2, flow, mask1 = self.cache[index]
        else:
            with open(self.datapath[index], "rb") as fp:
                data = np.load(fp)
                pos1 = data["points1"].astype(np.float32)
                pos2 = data["points2"].astype(np.float32)
                color1 = data["color1"].astype(np.float32)
                color2 = data["color2"].astype(np.float32)
                flow = data["flow"].astype(np.float32)
                mask1 = data["valid_mask1"]
            if len(self.cache) < 30000:
                self.cache[index] = (pos1, pos2, color1, color2, flow, mask1)

        if self.partition == "train":
            s1 = self.rng.choice(pos1.shape[0], self.npoints, replace=False)
            s2 = self.rng.choice(pos2.shape[0], self.npoints, replace=False)
        else:
            s1 = s2 = np.arange(self.npoints)
        pos1, color1, flow, mask1 = pos1[s1], color1[s1], flow[s1], mask1[s1]
        pos2, color2 = pos2[s2], color2[s2]
        center = pos1.mean(0)
        return pos1 - center, pos2 - center, color1, color2, flow, mask1
