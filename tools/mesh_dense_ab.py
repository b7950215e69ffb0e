#!/usr/bin/env python3
"""Phase 24 (a) of chip_smoke.py (``mesh_dense``: stablelm-3b's decode on
one rank, over 1 x 4 and over 2 x 2, every rank on the card) from the
checkout at ROOT; prints one JSON line of the median ms a step.

    python3 tools/mesh_dense_ab.py ROOT

Compare two trees on one card by alternating them in one call (parent,
change, change, parent), the parent unpacked under the ignored build/."""
import json
import os
import subprocess
import sys

root = os.path.abspath(sys.argv[1])
sys.path[:0] = [root, os.path.join(root, "src")]
import chip_smoke as cs  # noqa: E402

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()
found = cs.mesh_dense(cs.lm_configs()[0], "cuda", smi)
print(json.dumps({"root": root, "one_ms": found["one_ms"],
                  **{k: v["ms"] for k, v in found.items() if isinstance(v, dict)}}), flush=True)
