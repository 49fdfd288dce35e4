"""Information-ceiling baselines for conditional-parity metrics.

The reference reports conditional metrics (CN2 angle R^2,
ref CN2_evaluate.py:176-286) without asking how much of the target the
conditioning *determines*: when the spectrum only partially encodes the
local geometry, no model — however well trained — can reach R^2 = 1, and a
mediocre-looking score may in fact sit at the ceiling. The standard probe is
a 1-nearest-neighbour regressor in conditioning space: its score estimates
the information actually present in the spectra (up to smoothness), so a
model within a few points of it has extracted what there is to extract.
"""

from __future__ import annotations

import numpy as np


def spectrum_nn_predict(train_spectra: np.ndarray, train_values: np.ndarray,
                        test_spectra: np.ndarray) -> np.ndarray:
    """1-NN regression: each test row gets the target value of the training
    row with the closest spectrum (squared-Euclidean distance).

    Args:
      train_spectra: ``[Ntr, S]``; train_values: ``[Ntr]`` or ``[Ntr, D]``;
      test_spectra: ``[Nte, S]``.

    Returns:
      predicted values ``[Nte]`` (or ``[Nte, D]``).
    """
    tr = np.asarray(train_spectra, np.float64)
    te = np.asarray(test_spectra, np.float64)
    # ||te - tr||^2 = |te|^2 - 2 te.tr + |tr|^2 ; argmin over train rows
    d2 = (
        (te**2).sum(-1, keepdims=True)
        - 2.0 * te @ tr.T
        + (tr**2).sum(-1)[None, :]
    )
    nn = np.argmin(d2, axis=1)
    return np.asarray(train_values)[nn]


def nn_ceiling_r2(train_spectra, train_values, test_spectra, test_values,
                  r2score=None) -> float:
    """R^2 of the 1-NN baseline on the held-out set — the score to compare a
    conditional model against before calling it weak."""
    if r2score is None:
        from diffusion_model.evals.cn2 import r2score
    pred = spectrum_nn_predict(train_spectra, train_values, test_spectra)
    return float(r2score(np.asarray(test_values), pred))
