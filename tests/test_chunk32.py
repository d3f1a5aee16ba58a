"""Production-CHUNK coverage: re-run the chunk-walk equivalence tests at
RASTER_CHUNK=32 — the shipped default (kernels/raster.py).

The CPU suite pins RASTER_CHUNK=8 (tests/conftest.py: interpret-mode cost
scales with the chunk unroll), so the CHUNK=32 / 4-group gmask configuration
the card runs would otherwise only be exercised by chip_smoke.py and the
CLI. raster.CHUNK is frozen at import, so the re-run needs a fresh
interpreter: one subprocess pytest per test with the env override.

Run with: python -m pytest tests/ -m chunk32
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.chunk32

# The highest-value equivalences: the chunk walk vs the deferred walk for
# the opaque and peel rules.
_TESTS = [
    "tests/test_chunk_streaming.py::test_chunk_raster_matches_deferred_raster",
    "tests/test_chunk_streaming.py::test_chunk_peel_matches_deferred_peel",
    # N_GROUPS=4 only at CHUNK=32: the real per-group gmask skip path
    "tests/test_chunk_streaming.py::test_gmask_bins_match_all_live",
]


def test_chunk32_equivalence_subprocess():
    env = os.environ.copy()
    env["RASTER_CHUNK"] = "32"
    # single tile: interpret-mode cost scales with n_tiles x entries x CHUNK
    env["CHUNK_TEST_TILES"] = "1,2"
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # the cost is per-test kernel TRACING at the CHUNK=32 unroll, so the two
    # tests run as parallel subprocesses (wall = slowest test, not the sum)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "pytest", "-q", "-m", "", t],
            cwd=cwd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for t in _TESTS
    ]
    for t, p in zip(_TESTS, procs):
        out, _ = p.communicate(timeout=1200)
        assert p.returncode == 0, f"CHUNK=32 run failed for {t}:\n{out}"
        assert "1 passed" in out, out
