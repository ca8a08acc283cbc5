"""nfclab_torch.shard across processes on the CPU: 2 and 3 gloo ranks.

The counterpart of tests/test_multichip.py's two-process run
(tests/dist_child.py), on a seeded capture instead of its absent WAV.
Every rank (tests/torch_dist_child.py) joins one group by a file-store
rendezvous under tmp_path (no TCP port, so concurrent test workers never
meet), lays the ``blocks`` layout over the ranks, and runs
``decode_sharded`` (with the channels it computes) and
``sharded_kernel_channels`` (L = 3968, H = 128) on its blocks, and lays
a (stream, time) DeviceMesh (``make_mesh``, ``shard_batch``): the halos
cross the process boundaries both ways over the ring, and the rows are
all-gathered.  The capture's 13 blocks leave padding rows at 2 and 3
ranks.  Every rank's channels must equal the one-rank run's bit for bit,
(equal sha256 digests of the bytes), and its frames those of the one-rank
``decode_sharded`` and of ``NfcDecoder().decode``.
"""

import json

import numpy as np
import pytest

import torch_synth

RATE = torch_synth.RATE
KERNEL_LH = (3968, 128)


def _frames_json(frames):
    from nfclab_torch.apps.decode_cli import frame_json

    return [frame_json(f) for f in frames]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The capture (five template lanes back to back) and its one-rank
    channels and frames."""
    from nfclab_torch.runtime.decoder import NfcDecoder
    from nfclab_torch.shard.multichip import (
        decode_sharded, sharded_capture_channels, sharded_kernel_channels,
    )

    x = np.concatenate([torch_synth.lane(tp, 60_000, seed=40 + i)[0]
                        for i, tp in enumerate(torch_synth.templates())])
    path = tmp_path_factory.mktemp("capture") / "capture.npz"
    np.savez(path, samples=x, rate=RATE)
    cap = sharded_capture_channels(x, RATE, device="cpu")
    ker = sharded_kernel_channels(x, RATE, L=KERNEL_LH[0], H=KERNEL_LH[1],
                                  device="cpu")
    frames = _frames_json(decode_sharded(x, RATE, device="cpu"))
    host = _frames_json(NfcDecoder().decode(x, RATE))
    return path, cap, ker, frames, host


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_equal_one_rank(world, one_rank, tmp_path):
    from torch_dist_child import digest, run_world

    path, cap, ker, frames, host = one_rank
    assert frames == host and len(frames) > 10
    outs = run_world(world, path, tmp_path, kernel_lh=KERNEL_LH,
                     timeout=300)
    for rank, out in enumerate(outs):
        for name, want in (("cap", cap), ("ker", ker)):
            assert out[name] == {k: digest(v) for k, v in want.items()}, (
                rank, name)
        assert out["frames"] == frames, rank


def test_scaling_bench_on_gloo_ranks(capsys):
    """scaling_bench's CPU mode: world size 1 in this process, 2 as spawned
    gloo ranks; one JSON line each, with the step, the ring's share and
    the total against one rank."""
    from nfclab_torch.tools.scaling_bench import main

    assert main(["--device", "cpu", "--devices", "1", "2",
                 "--blocks-per-dev", "2", "--reps", "1"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["mesh"] for r in rows] == ["none-cpu", "gloo-cpu"]
    for r in rows:
        assert r["metric"] == "sharded_frontend_samples_per_second"
        assert r["device"] == "cpu" and r["blocks_per_device"] == 2
        assert r["value"] > 0 and r["step_ms"] > 0
        assert 0.0 <= r["collective_share"] < 1.0
    assert rows[0]["total_vs_1dev"] == 1.0
    assert rows[1]["total_vs_1dev"] == rows[1]["value"] / rows[0]["value"]
