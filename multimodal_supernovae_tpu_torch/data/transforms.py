"""The per-class cross-entropy weights of the supervised classification head
(a copy of ``CLASS_WEIGHTS`` in multimodal_supernovae_tpu/data/transforms.py,
which matches the reference's rough ZTF BTS class breakdown,
src/models_multimodal.py:337-345). The rest of that module (type merges,
padding and subsampling of real data) belongs to the host data layer
(ROADMAP.md queue 1, item 17)."""

from __future__ import annotations

import numpy as np

CLASS_WEIGHTS = {
    5: np.array([0.3, 0.08, 1.0, 0.01, 0.2], dtype=np.float32),
    3: np.array([0.33, 0.06, 1.0], dtype=np.float32),
}
