"""BlendVOCA test-split discovery and audio loading, for the port.

The port's own copy of what the eval-generation CLI needs from
``said_tpu.data.blendvoca`` (the canonical test subjects, sentences 1–40,
``get_data_paths`` for audio): that module imports pandas through
``said_tpu.utils.blendshape``, which the machine with the card lacks. The
CSV column names are ``said_tpu_torch.cli._common.ARKIT_BLENDSHAPES``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np

from said_tpu_torch.utils.audio import load_audio

PERSON_IDS_TEST = [
    "FaceTalk_170731_00024_TA",
    "FaceTalk_170809_00138_TA",
]
SENTENCE_IDS = list(range(1, 41))


@dataclasses.dataclass
class BlendVOCADataPath:
    person_id: str
    sentence_id: int
    audio: str


def get_data_paths(audio_dir: str, person_ids: Sequence[str] = PERSON_IDS_TEST) -> List[BlendVOCADataPath]:
    """``<audio_dir>/<person>/sentenceXX.wav`` for every subject and
    sentence that exists, in subject then sentence order."""
    paths = []
    for pid in person_ids:
        for sid in SENTENCE_IDS:
            audio = os.path.join(audio_dir, pid, f"sentence{sid:02}.wav")
            if os.path.exists(audio):
                paths.append(BlendVOCADataPath(pid, sid, audio))
    return paths


def load_test_audio(path: BlendVOCADataPath, sampling_rate: int = 16000) -> np.ndarray:
    """The clip's mono float32 waveform at ``sampling_rate``."""
    return load_audio(path.audio, sampling_rate)
