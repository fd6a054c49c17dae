"""Offline trajectory evaluation tooling (reference ``eval/`` role)."""

from .gps import GpsTool, gps_to_tum  # noqa: F401
from .metrics import ape, evaluate, rpe, umeyama_align  # noqa: F401
