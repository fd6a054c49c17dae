"""RTK-GPS ground-truth extraction: LLA -> ECEF -> ENU -> TUM.

Parity with the reference's ``eval/scripts/gps2tum.py:15-88`` (``GPSTool``):
WGS84 lla2ecef, ENU rotation about a fixed LLA origin, and RTK-fix gating
(``gga == 4``) before a position is trusted as ground truth. The reference
reads NavSatFix + GGA strings from a rosbag; this version consumes plain
arrays (or an iterator of records) so any log format can feed it — ROS is
deliberately not a dependency of this package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

WGS84_MAJOR = 6378137.0
WGS84_MINOR = 6356752.31424518
RTK_FIX = 4  # GGA quality indicator: RTK integer-ambiguity fix


class GpsTool:
    """LLA->ENU converter about a fixed origin (gps2tum.py:13-45)."""

    def __init__(self, lla_origin=(34.0, 113.0, 72.0)):
        self.lla_origin = np.asarray(lla_origin, np.float64)

    def lla2ecef(self, lla: np.ndarray) -> np.ndarray:
        """(..., 3) [lat deg, lon deg, alt m] -> (..., 3) ECEF meters."""
        lla = np.asarray(lla, np.float64)
        lat = np.radians(lla[..., 0])
        lon = np.radians(lla[..., 1])
        alt = lla[..., 2]
        r = WGS84_MAJOR ** 2 / np.sqrt(
            (WGS84_MAJOR * np.cos(lat)) ** 2 + (WGS84_MINOR * np.sin(lat)) ** 2
        )
        return np.stack([
            (r + alt) * np.cos(lat) * np.cos(lon),
            (r + alt) * np.cos(lat) * np.sin(lon),
            ((WGS84_MINOR / WGS84_MAJOR) ** 2 * r + alt) * np.sin(lat),
        ], axis=-1)

    def ecef2enu(self, ecef: np.ndarray) -> np.ndarray:
        lat = np.radians(self.lla_origin[0])
        lon = np.radians(self.lla_origin[1])
        rot = np.array([
            [-np.sin(lon), np.cos(lon), 0.0],
            [-np.cos(lon) * np.sin(lat), -np.sin(lat) * np.sin(lon), np.cos(lat)],
            [np.cos(lon) * np.cos(lat), np.sin(lon) * np.cos(lat), np.sin(lat)],
        ])
        return (np.asarray(ecef) - self.lla2ecef(self.lla_origin)) @ rot.T

    def get_enu(self, lla: np.ndarray) -> np.ndarray:
        return self.ecef2enu(self.lla2ecef(lla))


def gps_to_tum(stamps: np.ndarray, lla: np.ndarray,
               gga_quality: Optional[np.ndarray] = None,
               out_path: Optional[str] = None,
               lla_origin=(34.0, 113.0, 72.0)) -> np.ndarray:
    """Convert GPS fixes to a TUM ground-truth array (and optionally a file).

    Rows with ``gga_quality != 4`` (non-RTK-fixed) are dropped — the
    reference's ``gga[i] == 4`` gate. Returns (K, 8) rows
    ``stamp x y z qx qy qz qw`` with identity orientation (z kept, unlike
    the reference which flattens z to 0 only in the written string — here
    both the array and the file carry the ENU z so planar evaluation is a
    caller choice).
    """
    stamps = np.asarray(stamps, np.float64)
    lla = np.asarray(lla, np.float64)
    if gga_quality is not None:
        keep = np.asarray(gga_quality) == RTK_FIX
        stamps, lla = stamps[keep], lla[keep]
    enu = GpsTool(lla_origin).get_enu(lla)
    rows = np.zeros((len(stamps), 8))
    rows[:, 0] = stamps
    rows[:, 1:4] = enu
    rows[:, 7] = 1.0  # identity quaternion
    if out_path:
        np.savetxt(out_path, rows,
                   fmt="%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f")
    return rows
