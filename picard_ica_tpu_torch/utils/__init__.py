"""Evaluation metrics, the density check, seeded synthetic data, the
reference RNG."""

from . import datagen, metrics, reference_rng
from .datagen import generate_mixed_kurtosis_data, generate_test_data
from .metrics import amari_distance, check_density, permute

__all__ = [
    "datagen",
    "metrics",
    "reference_rng",
    "amari_distance",
    "check_density",
    "permute",
    "generate_test_data",
    "generate_mixed_kurtosis_data",
]
