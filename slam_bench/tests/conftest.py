"""The benchmark's own tests run on the CPU from the repository root:
`python -m pytest slam_bench/tests -q`. They import the harness as the
`slam_bench` package."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
