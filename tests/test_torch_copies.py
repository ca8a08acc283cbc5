"""The host layer of nfclab_torch is a copy of nfclab's: each copied module
must equal its nfclab original except in import lines (and the one listed
edit of native/build.py), each copied function or class in a ported module
likewise, and the native C++ sources byte for byte.  A fix made on one
side only fails here."""

import ast
import difflib
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent

COPIED = [
    "core/__init__.py", "core/frame.py", "core/nfc.py", "core/params.py",
    "core/thresholds.py", "core/streamview.py", "core/malloc_tune.py",
    "protocol/__init__.py", "protocol/crc.py",
    "io/__init__.py", "io/wav.py", "io/golden.py",
    "native/__init__.py", "native/binding.py", "native/build.py",
    "demod/__init__.py", "demod/common.py", "demod/nfca.py",
    "demod/nfcb.py", "demod/nfcf.py", "demod/nfcv.py",
    "dsp/__init__.py", "dsp/channels.py", "dsp/debugtap.py",
    "runtime/__init__.py", "runtime/native_walk.py", "runtime/decoder.py",
    "runtime/streaming.py",
    "runtime/subject.py", "runtime/metrics.py", "runtime/config.py",
    "runtime/logging.py",
    "hw/__init__.py", "hw/signal.py", "hw/device.py", "hw/record.py",
    "hw/sdr.py",
    "dsp/magnitude.py", "dsp/resample.py", "io/trz.py",
    "demod/iso7816.py",
    "protocol/parser/__init__.py", "protocol/parser/tree.py",
    "protocol/parser/base.py", "protocol/parser/nfca.py",
    "protocol/parser/nfcb.py", "protocol/parser/nfcf.py",
    "protocol/parser/nfcv.py", "protocol/parser/iso7816.py",
    "protocol/parser/dispatch.py",
    "tools/__init__.py", "tools/analyze.py", "tools/html_report.py",
    "tools/trace_cli.py", "apps/monitor.py", "shard/__init__.py",
    "tools/hw_smoke.py",
]

# functions and classes copied into modules that are ported, not copied,
# as a whole
COPIED_FUNCTIONS = [
    ("dsp/conditioner.py", "_edge_tracker"),
    ("dsp/frontend.py", "_params_tuple"),
    ("dsp/frontend.py", "_default_corr_thresholds"),
    ("runtime/farm.py", "KernelFedStream"),
    ("runtime/farm.py", "_init_idx_entries"),
    ("runtime/farm.py", "_append_mask_idx"),
    ("runtime/farm.py", "_append_sparse_idx"),
    ("runtime/farm.py", "_DispatchPipeline"),
    ("runtime/farm.py", "MaskFedStream"),
    ("runtime/pipeline.py", "Executor"),
    ("runtime/pipeline.py", "Task"),
    ("runtime/pipeline.py", "RadioSourceTask"),
    ("runtime/pipeline.py", "LiveRadioSourceTask"),
    ("runtime/pipeline.py", "ResamplingTask"),
    ("runtime/pipeline.py", "DeviceMonitorTask"),
    ("runtime/pipeline.py", "SignalStorageTask"),
    ("runtime/pipeline.py", "TraceStorageTask"),
    ("runtime/pipeline.py", "TraceReplayTask"),
    ("runtime/pipeline.py", "run_radio_pipeline"),
    ("apps/decode_cli.py", "reconcile_decoder"),
    ("apps/decode_cli.py", "_parse_channel_map"),
    ("runtime/logic_decoder.py", "normalize_channel_map"),
    ("runtime/logic_decoder.py", "IsoDecoder"),
    ("runtime/logic_decoder.py", "_GrowIdx"),
    ("dsp/logic_frontend.py", "event_indices"),
    ("runtime/pipeline.py", "LogicDecoderTask"),
    ("runtime/pipeline.py", "LogicSourceTask"),
    ("runtime/pipeline.py", "LiveLogicSourceTask"),
    ("dsp/spectrum.py", "make_window"),
    ("shard/temporal.py", "overlap_save_blocks"),
    ("shard/temporal.py", "stitch_blocks"),
    ("tools/validate_rate_parametric.py", "_resampled"),
    ("tools/e2e_bench.py", "_burn"),
    ("tools/e2e_bench.py", "_cpu_capacity"),
]

# the port's native build is atomic: nfclab's writes the library in place,
# so a process loading it while another compiles gets a truncated file
EDITS = {
    "native/build.py": [(
        '''    compiler flags, or build host changed). Returns its path."""
    out = lib_path()
    srcs = [_SRC_DIR / s for s in SOURCES]
    stamp_file = _BUILD_DIR / "flags.stamp"
    stamp = _stamp()
    if not force and out.exists():
        deps = srcs + [_SRC_DIR / h for h in HEADERS]
        newest_src = max(s.stat().st_mtime for s in deps)
        stamp_ok = stamp_file.exists() and stamp_file.read_text() == stamp
        if out.stat().st_mtime >= newest_src and stamp_ok:
            return out
    _BUILD_DIR.mkdir(exist_ok=True)
    cmd = ["g++", *CXXFLAGS, "-o", str(out), *[str(s) for s in srcs], "-ldl"]
    subprocess.run(cmd, check=True, capture_output=True)
    stamp_file.write_text(stamp)
''',
        '''    compiler flags, or build host changed). Returns its path.

    Safe across processes: one process compiles, under an exclusive lock
    on ``_build/build.lock``, into a temporary file that replaces the
    library in one rename; the others wait on the lock and find it
    current, and no process ever maps a half-written library."""
    out = lib_path()
    srcs = [_SRC_DIR / s for s in SOURCES]
    stamp_file = _BUILD_DIR / "flags.stamp"
    stamp = _stamp()

    def current() -> bool:
        if not out.exists():
            return False
        deps = srcs + [_SRC_DIR / h for h in HEADERS]
        newest_src = max(s.stat().st_mtime for s in deps)
        stamp_ok = stamp_file.exists() and stamp_file.read_text() == stamp
        return out.stat().st_mtime >= newest_src and stamp_ok

    if not force and current():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    with open(_BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and current():  # built by another process meanwhile
            return out
        fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so")
        os.close(fd)
        try:
            cmd = ["g++", *CXXFLAGS, "-o", tmp, *[str(s) for s in srcs],
                   "-ldl"]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        stamp_file.write_text(stamp)
''',
    )],
}


def _is_import(line: str) -> bool:
    s = line.strip()
    return s.startswith("from ") or s.startswith("import ")


def _assert_same_but_imports(rel, orig: str, port: str):
    a, b = orig.splitlines(), port.splitlines()
    sm = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
    for op, i1, i2, j1, j2 in sm.get_opcodes():
        if op == "equal":
            continue
        changed = a[i1:i2] + b[j1:j2]
        assert all(_is_import(ln) for ln in changed), (
            f"{rel}: non-import lines differ: {changed}")


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_nfclab(rel):
    orig = (ROOT / "nfclab" / rel).read_text()
    for old, new in EDITS.get(rel, []):
        assert orig.count(old) == 1, "listed edit no longer applies"
        orig = orig.replace(old, new)
    port = (ROOT / "nfclab_torch" / rel).read_text()
    _assert_same_but_imports(rel, orig, port)


def _function_source(path: Path, name: str) -> str:
    src = path.read_text()
    for node in ast.parse(src).body:
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                and node.name == name):
            return ast.get_source_segment(src, node)
    raise AssertionError(f"{path}: no function or class {name}")


@pytest.mark.parametrize("rel,name", COPIED_FUNCTIONS,
                         ids=[f"{r}::{n}" for r, n in COPIED_FUNCTIONS])
def test_copied_function_matches_nfclab(rel, name):
    _assert_same_but_imports(
        f"{rel}::{name}", _function_source(ROOT / "nfclab" / rel, name),
        _function_source(ROOT / "nfclab_torch" / rel, name))


def test_native_sources_identical():
    src = ROOT / "nfclab" / "native" / "src"
    names = sorted(p.name for p in src.iterdir() if p.is_file())
    assert names
    dst = ROOT / "nfclab_torch" / "native" / "src"
    assert sorted(p.name for p in dst.iterdir() if p.is_file()) == names
    for n in names:
        assert (src / n).read_bytes() == (dst / n).read_bytes(), n


def test_native_build_dir_is_the_ports():
    from nfclab_torch.native import build

    assert build.lib_path().parent == ROOT / "nfclab_torch" / "native" / "_build"


def test_logic_synth_make_session_is_test_iso7816s():
    """tests/torch_logic_synth.py's session builder (no nfclab import)
    builds tests/test_iso7816.py's captures sample for sample."""
    import test_iso7816
    import torch_logic_synth

    for kw in ({}, {"atr": (0x3B, 0x02, 0x41, 0x42)},
               {"atr": (0x3B, 0x00),
                "tpdu": [0x00, 0xA4, 0x04, 0x00, 0x02, 0xA4, 0x3F, 0x00,
                         0x90, 0x00], "idle_tail": 1000}):
        a = torch_logic_synth.make_session(**kw)
        b = test_iso7816.make_session(**kw)
        assert a.dtype == b.dtype and np.array_equal(a, b), kw
    for name in ("SAMPLE_RATE", "CLOCK_HZ", "ETU_SAMPLES"):
        assert getattr(torch_logic_synth, name) == getattr(test_iso7816, name)
    assert (torch_logic_synth._t1_crc(b"\x00\x00\x02\xa4\x04")
            == test_iso7816._t1_crc(b"\x00\x00\x02\xa4\x04"))
