"""Data pipelines: the paper's synthetic sensor fields and an LM token stream."""

from .fields import CASES, FieldCase, case1, case2, sample_field
from .lm import TokenStream, synthetic_lm_stream

__all__ = [
    "CASES",
    "FieldCase",
    "TokenStream",
    "case1",
    "case2",
    "sample_field",
    "synthetic_lm_stream",
]
