"""The data and fit cases of tests/test_torch_parallel.py, shared by the
test module and its gloo workers (tests/torch_parallel_worker.py): all
made from seeds with NumPy, so every rank and the JAX side see the same
arrays."""

import numpy as np
import torch

from picard_ica_tpu_torch import Cube, Exp
from picard_ica_tpu_torch.utils import generate_mixed_kurtosis_data

# T divisible by 1, 2 and 3 ranks.
N, T = 6, 12_000

# name -> (data, PicardConfig fields beside random_state=0; f64 unless
# the fields say otherwise).
FITS = {
    "fit": ("mixed", {}),
    "kernels": ("mixed", {"use_kernels": True}),
    "fastica_nonortho": ("laplace", {"ortho": False, "extended": True, "fastica_it": 2,
                                     "tol": 1e-6}),
    "cube": ("uniform", {"density": Cube(), "extended": False, "tol": 1e-6}),
    "exp": ("laplace", {"density": Exp(), "extended": True, "tol": 1e-6}),
    "jade": ("mixed", {"jade_it": 5}),
    "f32": ("mixed", {"dtype": torch.float32}),
}


def fit_data(name):
    """(sources, mixing, X) as float64 NumPy."""
    if name == "mixed":
        return generate_mixed_kurtosis_data(N, T, 3)
    rng = np.random.default_rng(9)
    if name == "uniform":
        s = rng.uniform(-np.sqrt(3.0), np.sqrt(3.0), size=(4, T))
    else:
        u = rng.uniform(1e-6, 1.0, size=(4, T))
        s = np.sign(rng.standard_normal((4, T))) * (-np.log(u))
    a = rng.standard_normal((4, 4))
    return s, a, a @ s


def moments_data():
    return np.random.default_rng(0).standard_normal((4, 1200))


def whitening_data(name):
    """f32 data for the whitening statistics: the CPU's chunked route at
    N = 6, and N = 520, past the resident covariance's 512 rows."""
    if name == "chunked":
        return fit_data("mixed")[2].astype(np.float32)
    rng = np.random.default_rng(5)
    s = rng.laplace(size=(520, 4200))
    return (rng.standard_normal((520, 520)) @ s).astype(np.float32)
