"""nfclab_torch imports neither JAX nor anything of nfclab or of the
repository's experiments/: every module of the port, and chip_smoke.py
with the synth, mock-server and monitor helpers it uses, import and run their
module-level code in a fresh interpreter where `jax` and `experiments`
are blocked, and no `jax*`, `nfclab.*` or `experiments*` module ends up
loaded."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["experiments"] = None
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tests")
import nfclab_torch
names = [m.name for m in pkgutil.walk_packages(nfclab_torch.__path__,
                                               "nfclab_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch_synth
import torch_sdr_mocks
import torch_logic_synth
import torch_monitor
import torch_dist_child
torch_synth.templates()
torch_monitor.polled_monitor()
torch_logic_synth.logic_lane(200_000, seed=0)
bad = sorted(m for m in sys.modules
             if m in ("jax", "experiments") and sys.modules[m] is not None
             or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "nfclab" or m.startswith("nfclab.")
             or m.startswith("experiments."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_nfclab():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT)],
        capture_output=True, text=True, cwd=ROOT / "tests", env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["bad"] == []
    mods = set(out["modules"])
    for need in ("nfclab_torch.dsp.fused_frontend",
                 "nfclab_torch.dsp.cuda_channels",
                 "nfclab_torch.kernels.fused",
                 "nfclab_torch.apps.decode_cli",
                 "nfclab_torch.runtime.decoder",
                 "nfclab_torch.native.binding",
                 "nfclab_torch.dsp.conditioner_kernel",
                 "nfclab_torch.dsp.conditioner",
                 "nfclab_torch.dsp.frontend",
                 "nfclab_torch.kernels.conditioner",
                 "nfclab_torch.runtime.batch",
                 "nfclab_torch.runtime.streaming",
                 "nfclab_torch.runtime.farm",
                 "nfclab_torch.apps.bench_cli",
                 "nfclab_torch.kernels.probes",
                 "nfclab_torch.kernels.fused_v2",
                 "nfclab_torch.experiments.membw_probe",
                 "nfclab_torch.experiments.probe_serial_floor",
                 "nfclab_torch.experiments.probe_pair_spec",
                 "nfclab_torch.experiments.fused_v2",
                 "nfclab_torch.experiments.bench_v2",
                 "nfclab_torch.runtime.pipeline",
                 "nfclab_torch.hw.sdr",
                 "nfclab_torch.demod.iso7816",
                 "nfclab_torch.dsp.logic_frontend",
                 "nfclab_torch.runtime.logic_decoder",
                 "nfclab_torch.dsp.spectrum",
                 "nfclab_torch.protocol.parser.dispatch",
                 "nfclab_torch.tools.html_report",
                 "nfclab_torch.tools.trace_cli",
                 "nfclab_torch.apps.monitor",
                 "nfclab_torch.shard",
                 "nfclab_torch.shard.mesh",
                 "nfclab_torch.shard.temporal",
                 "nfclab_torch.shard.launch",
                 "nfclab_torch.shard.multichip",
                 "nfclab_torch.tools.scaling_bench",
                 "nfclab_torch.tools.validate_cuda_shard_kernel",
                 "nfclab_torch.tools.hw_smoke",
                 "nfclab_torch.tools.validate_fused",
                 "nfclab_torch.tools.validate_cuda_decode",
                 "nfclab_torch.tools.validate_rate_parametric",
                 "nfclab_torch.tools.validate_cuda_farm",
                 "nfclab_torch.tools.validate_cuda_logic",
                 "nfclab_torch.tools.e2e_bench",
                 "nfclab_torch.tools.streaming_bench",
                 "nfclab_torch.tools.fixtures"):
        assert need in mods


def test_port_sources_name_no_jax_or_nfclab_import():
    """No source line of the port imports jax, the nfclab package or the
    repository's experiments/."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+(jax|nfclab|experiments)(\.|\s|$)")
    files = list((ROOT / "nfclab_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_sdr_mocks.py",
              ROOT / "tests" / "torch_logic_synth.py",
              ROOT / "tests" / "torch_monitor.py",
              ROOT / "tests" / "torch_dist_child.py"]
    for f in files:
        for ln in f.read_text().splitlines():
            assert not pat.match(ln), f"{f}: {ln}"
