"""BlendVOCA for the port: splits, discovery, and the train and validation
datasets with their windowing, augmentation and collates.

The port's own copy of what it needs from ``said_tpu.data.blendvoca``
(that module reads CSVs with pandas, which the machine with the card
lacks). Behaviour, from the reference's ``script/dataset/dataset_voca.py``:

- the canonical subject splits (8 train / 2 val / 2 test FaceTalk IDs),
  sentences 1–40, 60 fps, the 32 ARKit classes and their 11 L/R mirror
  pairs;
- discovery with the repeat regex ``(-.+)?`` (``sentenceXX-k.csv``);
- the train collate windows: one random window size a batch in
  [window_size_min, shortest sequence], edge padding, a random start
  offset, an optional ±1-sample audio delay;
- per item: the CFG uncondition draw, a horizontal flip that swaps the
  mirror pairs' columns, an optional zero-out;
- the evaluation sets: the test split's generated or real CSVs with their
  person and sentence (``BlendVOCAEvalDataset``), and the coefficient-only
  120-frame windows the BCVAE trains on (``BlendVOCAVAEDataset``);
- the pseudo-GT optimizer's meshes (``BlendVOCAPseudoGTOptDataset``).

All host-side numpy with one ``np.random.Generator`` a dataset, drawn in
the JAX package's order, so the same seed gives the same batches bit for
bit.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from said_tpu_torch.utils.audio import load_audio
from said_tpu_torch.utils.blendshape import load_blendshape_coeffs, load_blendshape_deltas
from said_tpu_torch.utils.mesh import Mesh, load_mesh

PERSON_IDS_TRAIN = [
    "FaceTalk_170725_00137_TA",
    "FaceTalk_170728_03272_TA",
    "FaceTalk_170811_03274_TA",
    "FaceTalk_170904_00128_TA",
    "FaceTalk_170904_03276_TA",
    "FaceTalk_170912_03278_TA",
    "FaceTalk_170913_03279_TA",
    "FaceTalk_170915_00223_TA",
]
PERSON_IDS_VAL = [
    "FaceTalk_170811_03275_TA",
    "FaceTalk_170908_03277_TA",
]
PERSON_IDS_TEST = [
    "FaceTalk_170731_00024_TA",
    "FaceTalk_170809_00138_TA",
]
SENTENCE_IDS = list(range(1, 41))
FPS = 60

# the order of said_tpu/data/assets/ARKit_blendshapes.txt (the CSV header)
BLENDSHAPE_CLASSES = [
    "jawForward", "jawLeft", "jawRight", "jawOpen", "mouthClose",
    "mouthFunnel", "mouthPucker", "mouthLeft", "mouthRight",
    "mouthSmileLeft", "mouthSmileRight", "mouthFrownLeft", "mouthFrownRight",
    "mouthDimpleLeft", "mouthDimpleRight", "mouthStretchLeft",
    "mouthStretchRight", "mouthRollLower", "mouthRollUpper",
    "mouthShrugLower", "mouthShrugUpper", "mouthPressLeft", "mouthPressRight",
    "mouthLowerDownLeft", "mouthLowerDownRight", "mouthUpperUpLeft",
    "mouthUpperUpRight", "cheekPuff", "cheekSquintLeft", "cheekSquintRight",
    "noseSneerLeft", "noseSneerRight",
]

BLENDSHAPE_MIRROR_PAIRS = [
    ("jawLeft", "jawRight"),
    ("mouthLeft", "mouthRight"),
    ("mouthSmileLeft", "mouthSmileRight"),
    ("mouthFrownLeft", "mouthFrownRight"),
    ("mouthDimpleLeft", "mouthDimpleRight"),
    ("mouthStretchLeft", "mouthStretchRight"),
    ("mouthPressLeft", "mouthPressRight"),
    ("mouthLowerDownLeft", "mouthLowerDownRight"),
    ("mouthUpperUpLeft", "mouthUpperUpRight"),
    ("cheekSquintLeft", "cheekSquintRight"),
    ("noseSneerLeft", "noseSneerRight"),
]


@dataclasses.dataclass
class DataItem:
    waveform: Optional[np.ndarray]  # (T_a,)
    blendshape_coeffs: Optional[np.ndarray]  # (T_b, C)
    cond: bool = True
    blendshape_delta: Optional[np.ndarray] = None  # (C, |V|, 3)
    person_id: Optional[str] = None
    sentence_id: Optional[int] = None


@dataclasses.dataclass
class DataBatch:
    waveform: List[np.ndarray]
    blendshape_coeffs: Optional[np.ndarray]  # (B, T_b, C)
    cond: np.ndarray  # (B,) bool
    blendshape_delta: Optional[np.ndarray] = None  # (B, C, |V|, 3)


@dataclasses.dataclass
class BlendVOCADataPath:
    person_id: str
    sentence_id: int
    audio: Optional[str]
    blendshape_coeffs: Optional[str] = None


def get_data_paths(
    audio_dir: str,
    person_ids: Sequence[str] = PERSON_IDS_TEST,
    blendshape_coeffs_dir: Optional[str] = None,
    repeat_regex: str = "(-.+)?",
) -> List[BlendVOCADataPath]:
    """``<audio_dir>/<person>/sentenceXX.wav`` for every subject and
    sentence that exists, in subject then sentence order; with
    ``blendshape_coeffs_dir``, one path per coefficient CSV of the
    sentence (``sentenceXX<repeat_regex>.csv``, sorted) where the
    subject's CSV directory exists."""
    paths = []
    for pid in person_ids:
        coeffs_id_dir = os.path.join(blendshape_coeffs_dir, pid) if blendshape_coeffs_dir else None
        for sid in SENTENCE_IDS:
            base = f"sentence{sid:02}"
            audio = os.path.join(audio_dir, pid, f"{base}.wav")
            if not os.path.exists(audio):
                continue
            if coeffs_id_dir and os.path.exists(coeffs_id_dir):
                pattern = re.compile(rf"^{base}{repeat_regex}\.csv$")
                for filename in sorted(os.listdir(coeffs_id_dir)):
                    if pattern.match(filename):
                        paths.append(BlendVOCADataPath(pid, sid, audio, os.path.join(coeffs_id_dir, filename)))
            else:
                paths.append(BlendVOCADataPath(pid, sid, audio))
    return paths


def load_test_audio(path: BlendVOCADataPath, sampling_rate: int = 16000) -> np.ndarray:
    """The clip's mono float32 waveform at ``sampling_rate``."""
    return load_audio(path.audio, sampling_rate)


def _mirror_index_maps(classes, pairs) -> Tuple[List[int], List[int]]:
    src, dst = [], []
    for left, right in pairs:
        il, ir = classes.index(left), classes.index(right)
        src.extend([il, ir])
        dst.extend([ir, il])
    return src, dst


def default_collate(items: List[DataItem]) -> DataBatch:
    """Stack same-length items (the validation collate)."""
    coeffs = None
    if items and items[0].blendshape_coeffs is not None:
        coeffs = np.stack([it.blendshape_coeffs for it in items])
    deltas = None
    if items and items[0].blendshape_delta is not None:
        deltas = np.stack([it.blendshape_delta for it in items])
    return DataBatch(
        waveform=[np.asarray(it.waveform) for it in items],
        blendshape_coeffs=coeffs,
        cond=np.array([it.cond for it in items], dtype=bool),
        blendshape_delta=deltas,
    )


class _Preloaded:
    """Audio, coefficients and per-person blendshape deltas, read once."""

    def _preload(self, person_ids, audio_dir, coeffs_dir, deltas_path, landmarks_path, sampling_rate):
        self.data_paths = get_data_paths(audio_dir, person_ids, coeffs_dir)
        deltas = load_blendshape_deltas(deltas_path) if deltas_path else None
        landmarks = None
        if landmarks_path:
            with open(landmarks_path) as f:
                landmarks = [int(line.strip()) for line in f.readlines()]
        self.data_preload = []
        self.deltas: Dict[str, Optional[np.ndarray]] = {}
        for data in self.data_paths:
            if data.blendshape_coeffs is None:
                raise FileNotFoundError(f"missing coeffs for {data.audio}")
            self.data_preload.append((load_audio(data.audio, sampling_rate),
                                      load_blendshape_coeffs(data.blendshape_coeffs)))
            if data.person_id not in self.deltas:
                delta = _person_deltas(deltas, data.person_id)
                if delta is not None and landmarks:
                    delta = delta[:, landmarks, :]
                self.deltas[data.person_id] = delta

    def __len__(self) -> int:
        return len(self.data_paths)


class BlendVOCATrainDataset(_Preloaded):
    """Training set: full clips in RAM; the windowing happens in collate."""

    def __init__(
        self,
        audio_dir: str,
        blendshape_coeffs_dir: str,
        blendshape_deltas_path: Optional[str] = None,
        landmarks_path: Optional[str] = None,
        sampling_rate: int = 16000,
        window_size_min: int = 120,
        uncond_prob: float = 0.1,
        zero_prob: float = 0.0,
        hflip: bool = True,
        delay: bool = True,
        delay_thres: int = 1,
        classes: List[str] = BLENDSHAPE_CLASSES,
        classes_mirror_pair=BLENDSHAPE_MIRROR_PAIRS,
        seed: int = 0,
    ):
        self.sampling_rate = sampling_rate
        self.window_size_min = window_size_min
        self.uncond_prob = uncond_prob
        self.zero_prob = zero_prob
        self.hflip = hflip
        self.delay = delay
        self.delay_thres = delay_thres
        self.fps = FPS
        self.rng = np.random.default_rng(seed)
        self.mirror_src, self.mirror_dst = _mirror_index_maps(classes, classes_mirror_pair)
        self._preload(PERSON_IDS_TRAIN, audio_dir, blendshape_coeffs_dir, blendshape_deltas_path, landmarks_path,
                      sampling_rate)

    def __getitem__(self, index: int) -> DataItem:
        waveform, coeffs = self.data_preload[index]
        coeffs = np.array(coeffs)  # a copy: the augmentations write to it
        cond = self.rng.uniform() > self.uncond_prob
        if self.hflip and self.rng.uniform() < 0.5:
            coeffs[:, self.mirror_src] = coeffs[:, self.mirror_dst]
        if self.rng.uniform() < self.zero_prob:
            waveform = np.zeros_like(waveform)
            coeffs = np.zeros_like(coeffs)
        return DataItem(waveform=waveform, blendshape_coeffs=coeffs, cond=cond,
                        blendshape_delta=self.deltas[self.data_paths[index].person_id])

    def collate_fn(self, items: List[DataItem]) -> DataBatch:
        """Batch windowing: a random size, edge padding, a random start,
        an optional ±delay_thres audio delay (the reference's collate,
        ``dataset_voca.py:522-624``)."""
        rng = self.rng
        cond = np.array([it.cond for it in items], dtype=bool)
        deltas = None
        if items and items[0].blendshape_delta is not None:
            deltas = np.stack([it.blendshape_delta for it in items])

        bc_min_len = min(it.blendshape_coeffs.shape[0] for it in items)
        window_size = int(rng.integers(self.window_size_min, bc_min_len + 1))
        waveform_window_len = (self.sampling_rate * window_size) // self.fps
        half_window = window_size // 2
        half_wave = waveform_window_len // 2

        wave_windows, coeff_windows = [], []
        for it in items:
            waveform, coeffs = it.waveform, it.blendshape_coeffs
            blendshape_len = coeffs.shape[0]
            bdx = int(rng.integers(-half_window, max(0, blendshape_len - half_window - 1) + 1))
            wdx = (self.sampling_rate * bdx) // self.fps
            if self.delay and rng.uniform() < 0.5:
                wdx = int(rng.integers(wdx - self.delay_thres, wdx + self.delay_thres + 1))

            bdx_update = bdx + half_window
            coeffs_padded = np.pad(coeffs, ((half_window, window_size), (0, 0)), mode="edge")
            coeff_windows.append(coeffs_padded[bdx_update : bdx_update + window_size])

            wdx_update = max(0, wdx + half_wave + self.delay_thres)
            wave_padded = np.pad(
                waveform, (half_wave + self.delay_thres, waveform_window_len + self.delay_thres), mode="edge"
            )
            wave_windows.append(wave_padded[wdx_update : wdx_update + waveform_window_len])

        return DataBatch(
            waveform=[np.asarray(w) for w in wave_windows],
            blendshape_coeffs=np.stack(coeff_windows),
            cond=cond,
            blendshape_delta=deltas,
        )


class BlendVOCAValDataset(_Preloaded):
    """Validation set: full-length sequences, audio fit to the coefficients'
    length."""

    def __init__(
        self,
        audio_dir: str,
        blendshape_coeffs_dir: str,
        blendshape_deltas_path: Optional[str] = None,
        landmarks_path: Optional[str] = None,
        sampling_rate: int = 16000,
        uncond_prob: float = 0.1,
        zero_prob: float = 0.0,
        seed: int = 0,
    ):
        self.sampling_rate = sampling_rate
        self.uncond_prob = uncond_prob
        self.zero_prob = zero_prob
        self.fps = FPS
        self.rng = np.random.default_rng(seed)
        self._preload(PERSON_IDS_VAL, audio_dir, blendshape_coeffs_dir, blendshape_deltas_path, landmarks_path,
                      sampling_rate)

    collate_fn = staticmethod(default_collate)

    def __getitem__(self, index: int) -> DataItem:
        waveform, coeffs = self.data_preload[index]
        coeffs = np.array(coeffs)
        window = _audio_for_coeffs(waveform, coeffs.shape[0], self.sampling_rate)
        cond = self.rng.uniform() > self.uncond_prob
        if self.rng.uniform() < self.zero_prob:
            window = np.zeros_like(window)
            coeffs = np.zeros_like(coeffs)
        return DataItem(waveform=window, blendshape_coeffs=coeffs, cond=cond,
                        blendshape_delta=self.deltas[self.data_paths[index].person_id])


def _person_deltas(deltas, person_id: str) -> Optional[np.ndarray]:
    """One person's (C, |V|, 3) blendshape deltas from the deltas pickle."""
    if not deltas:
        return None
    return np.stack(list(deltas[person_id].values()), axis=0).astype(np.float32)


def _audio_for_coeffs(waveform: np.ndarray, frames: int, sampling_rate: int) -> np.ndarray:
    """The waveform cut or zero-padded to ``frames`` frames' samples."""
    wave_len = (sampling_rate * frames) // FPS
    window = np.zeros(wave_len, dtype=np.float32)
    tmp = waveform[:wave_len]
    window[: tmp.shape[0]] = tmp
    return window


class BlendVOCAEvalDataset:
    """The test split's clips with their coefficient CSVs (generated ones:
    ``sentenceXX<repeat_regex>.csv``), person and sentence, read when an
    item is taken (the JAX CLI's ``preload=False``)."""

    def __init__(
        self,
        audio_dir: str,
        blendshape_coeffs_dir: str,
        blendshape_deltas_path: Optional[str] = None,
        sampling_rate: int = 16000,
        repeat_regex: str = "(-.+)?",
    ):
        self.sampling_rate = sampling_rate
        self.fps = FPS
        self.data_paths = get_data_paths(audio_dir, PERSON_IDS_TEST, blendshape_coeffs_dir, repeat_regex)
        self.blendshape_deltas = load_blendshape_deltas(blendshape_deltas_path) if blendshape_deltas_path else None

    collate_fn = staticmethod(default_collate)

    def __len__(self) -> int:
        return len(self.data_paths)

    def __getitem__(self, index: int) -> DataItem:
        data = self.data_paths[index]
        coeffs = load_blendshape_coeffs(data.blendshape_coeffs)
        window = _audio_for_coeffs(load_audio(data.audio, self.sampling_rate), coeffs.shape[0], self.sampling_rate)
        return DataItem(waveform=window, blendshape_coeffs=coeffs,
                        blendshape_delta=_person_deltas(self.blendshape_deltas, data.person_id),
                        person_id=data.person_id, sentence_id=data.sentence_id)


class BlendVOCAVAEDataset:
    """Coefficient-only items for BCVAE training: one ``window_size``-frame
    window an item at a random offset (edge-padded), a horizontal flip with
    probability ½ and an optional zero-out, drawn from one
    ``np.random.Generator`` in the JAX package's order."""

    def __init__(
        self,
        blendshape_coeffs_dir: str,
        window_size: int = 120,
        zero_prob: float = 0.0,
        hflip: bool = True,
        dataset_type: str = "train",
        classes: List[str] = BLENDSHAPE_CLASSES,
        classes_mirror_pair=BLENDSHAPE_MIRROR_PAIRS,
        seed: int = 0,
    ):
        self.window_size = window_size
        self.zero_prob = zero_prob
        self.hflip = hflip
        self.rng = np.random.default_rng(seed)
        self.mirror_src, self.mirror_dst = _mirror_index_maps(classes, classes_mirror_pair)
        person_ids = {"train": PERSON_IDS_TRAIN, "val": PERSON_IDS_VAL}.get(dataset_type, PERSON_IDS_TEST)
        self.data_paths = []
        for pid in person_ids:
            coeffs_id_dir = os.path.join(blendshape_coeffs_dir, pid)
            if not os.path.exists(coeffs_id_dir):
                continue
            for sid in SENTENCE_IDS:
                pattern = re.compile(rf"^sentence{sid:02}(-.+)?\.csv$")
                for filename in sorted(os.listdir(coeffs_id_dir)):
                    if pattern.match(filename):
                        self.data_paths.append(
                            BlendVOCADataPath(pid, sid, None, os.path.join(coeffs_id_dir, filename)))

    def __len__(self) -> int:
        return len(self.data_paths)

    def __getitem__(self, index: int) -> DataItem:
        rng = self.rng
        coeffs = load_blendshape_coeffs(self.data_paths[index].blendshape_coeffs)
        half = self.window_size // 2
        bdx = int(rng.integers(-half, max(0, coeffs.shape[0] - half - 1) + 1))
        padded = np.pad(coeffs, ((half, self.window_size), (0, 0)), mode="edge")
        window = np.array(padded[bdx + half : bdx + half + self.window_size])
        if self.hflip and rng.uniform() < 0.5:
            window[:, self.mirror_src] = window[:, self.mirror_dst]
        if rng.uniform() < self.zero_prob:
            window = np.zeros_like(window)
        return DataItem(waveform=None, blendshape_coeffs=window)

    @staticmethod
    def collate_fn(items: List[DataItem]) -> DataBatch:
        return DataBatch(waveform=[], blendshape_coeffs=np.stack([it.blendshape_coeffs for it in items]),
                         cond=np.array([it.cond for it in items], dtype=bool))


class BlendVOCAPseudoGTOptDataset:
    """What the pseudo-GT QP reads: each person's neutral and blendshape
    meshes (``<neutrals_dir>/<person>.obj``,
    ``<blendshapes_dir>/<person>/<name>.obj``) and each sentence's mesh
    sequence (every ``.obj`` and ``.ply`` under
    ``<mesh_seqs_dir>/<person>/sentenceXX``, in sorted path order)."""

    def __init__(self, neutrals_dir: str, blendshapes_dir: str, mesh_seqs_dir: str, blendshapes_names: List[str]):
        self.neutrals_dir = neutrals_dir
        self.blendshapes_dir = blendshapes_dir
        self.mesh_seqs_dir = mesh_seqs_dir
        self.blendshapes_names = blendshapes_names

    def get_blendshapes(self, person_id: str) -> Tuple[Mesh, Dict[str, Mesh]]:
        neutral = load_mesh(os.path.join(self.neutrals_dir, f"{person_id}.obj"))
        bl_dir = os.path.join(self.blendshapes_dir, person_id)
        return neutral, {name: load_mesh(os.path.join(bl_dir, f"{name}.obj")) for name in self.blendshapes_names}

    def get_mesh_seq(self, person_id: str, seq_id: int) -> List[Mesh]:
        seq_dir = os.path.join(self.mesh_seqs_dir, person_id, f"sentence{seq_id:02}")
        if not os.path.isdir(seq_dir):
            return []
        files = sorted(glob.glob(os.path.join(seq_dir, "**/*.obj"), recursive=True)
                       + glob.glob(os.path.join(seq_dir, "**/*.ply"), recursive=True))
        return [load_mesh(p) for p in files]
