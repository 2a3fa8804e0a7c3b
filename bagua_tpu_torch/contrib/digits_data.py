"""Real handwritten-digit data for the convergence gates.

Port of ``bagua_tpu/contrib/digits_data.py``, reading the port's own copy of
the vendored data: the UCI handwritten-digits set (1,797 real 8x8 scans,
the dataset scikit-learn packages as ``load_digits``) in
``data/digits_8x8.npz`` (~45 KB) beside this module, so nothing is
downloaded.  The split is the JAX package's, array for array.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_VENDORED = os.path.join(os.path.dirname(__file__), "data", "digits_8x8.npz")


def _raw_digits() -> Tuple[np.ndarray, np.ndarray]:
    if os.path.exists(_VENDORED):
        with np.load(_VENDORED) as z:
            return z["images"], z["labels"]
    # fallback for a source tree without the vendored file
    from sklearn.datasets import load_digits  # noqa: PLC0415

    d = load_digits()
    return d.data, d.target


def load_digits_dataset(
    test_frac: float = 0.15,
    seed: int = 0,
    train_multiple_of: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic train/test split of the real digits data.

    Returns ``(x_train, y_train, x_test, y_test)``; images are flat f32
    in [0, 1] (64 features), labels int32 in [0, 10).  The train split is
    truncated to a multiple of ``train_multiple_of`` so it shards evenly
    over the test mesh.
    """
    images, labels = _raw_digits()
    x = (np.asarray(images, np.float32) / 16.0)  # pixel range is 0..16
    y = np.asarray(labels, np.int32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(x))
    x, y = x[order], y[order]
    n_test = int(len(x) * test_frac)
    x_test, y_test = x[:n_test], y[:n_test]
    x_train, y_train = x[n_test:], y[n_test:]
    n_train = len(x_train) - len(x_train) % train_multiple_of
    return x_train[:n_train], y_train[:n_train], x_test, y_test
