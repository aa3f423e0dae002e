"""Lightweight event logging (the reference's ROS_INFO analog).

Port of orb_slam_tpu/utils/log.py (`DEBUG`, `dbg`, `info`), copied: set
SLAM_DEBUG=1 to stream per-stage mapping and loop events to stderr. The
call sites guard every message that would read a device value with
`if DEBUG:`, so without SLAM_DEBUG the log adds no host sync.
"""

from __future__ import annotations

import os
import sys

DEBUG = bool(os.environ.get("SLAM_DEBUG"))


def dbg(msg: str):
    if DEBUG:
        print(f"[slam] {msg}", file=sys.stderr, flush=True)


def info(msg: str):
    print(f"[slam] {msg}", file=sys.stderr, flush=True)
