"""bench.py delivery-contract smoke test.

``python bench.py --smoke`` must emit a parseable first JSON line, naming
the device it ran on, within 300 s on the CPU when the CPU is asked for
explicitly.  The real run prints the same fast lines first and only then
attempts the budgeted scale-22 headline (``bench.py:main``).
"""

import json
import os
import subprocess
import sys


def test_bench_first_line_fast():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # single CPU device is fine (and faster)
    p = subprocess.run(
        [sys.executable, "bench.py", "--smoke"],
        cwd=os.path.join(os.path.dirname(__file__), ".."),
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode == 0, p.stderr[-2000:]
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert lines, f"no JSON line in stdout: {p.stdout!r}"
    first = json.loads(lines[0])
    assert first["unit"] == "Mproducts/s"
    assert first["value"] > 0
    assert first["platform"] == "cpu"
    assert first["device_count"] == 1
    assert first["device_kind"]
