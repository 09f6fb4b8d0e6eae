"""The paper's synthetic sensor fields."""

from .fields import CASES, FieldCase, case1, case2, sample_field

__all__ = ["CASES", "FieldCase", "case1", "case2", "sample_field"]
