"""Evaluation metrics, the density check, seeded synthetic data, the
reference RNG, profiling and the device-memory model."""

from . import datagen, memory_model, metrics, profiling, reference_rng
from .datagen import generate_bench_data, generate_mixed_kurtosis_data, generate_test_data
from .metrics import amari_distance, check_density, permute
from .profiling import fit_with_timing, profile_fit

__all__ = [
    "datagen",
    "memory_model",
    "metrics",
    "profiling",
    "reference_rng",
    "amari_distance",
    "check_density",
    "permute",
    "generate_bench_data",
    "generate_test_data",
    "generate_mixed_kurtosis_data",
    "fit_with_timing",
    "profile_fit",
]
