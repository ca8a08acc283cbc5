"""Self-contained HTML trace report: frame table + protocol trees + waves.

Headless equivalent of the reference GUI's decode views (app-qt
`QtWindow`/`StreamModel` frame table with columns Id/Time/Delta/Rate/Tech/
Event/Flags/Data, `model/StreamModel.h:55-58`; parserView protocol detail
tree; radio/logic wave strips).  `render_html` produces one static page with
zero external dependencies, suitable for CI artifacts and sharing:

- capture summary (duration, frame counts per technology);
- frame table with the StreamModel columns, rows expandable to the
  ProtocolParser detail tree (same trees `test-parser` goldens check);
- an SVG wave strip per signal stream rendered from the adaptive
  (offset, value) render pairs (the `adaptive.signal` stream the reference
  GUI plots), with decoded frame spans overlaid.

Usage: ``python -m nfclab.tools.trace_cli capture.trz --html out.html``.
"""

from __future__ import annotations

import html
import json

import numpy as np

from ..core.frame import Frame, FrameFlags, FrameTech, FrameType
from .analyze import annotate_frames

_CARRIER_TYPES = {int(FrameType.NfcCarrierOn), int(FrameType.NfcCarrierOff)}

_FLAG_NAMES = (
    (FrameFlags.ShortFrame, "short"),
    (FrameFlags.Encrypted, "enc"),
    (FrameFlags.Truncated, "trunc"),
    (FrameFlags.ParityError, "PAR!"),
    (FrameFlags.CrcError, "CRC!"),
    (FrameFlags.SyncError, "SYNC!"),
)

_CSS = """
body { font: 13px/1.45 system-ui, sans-serif; margin: 1.5em; color: #1a1a2e; }
h1 { font-size: 1.3em; } h2 { font-size: 1.05em; margin-top: 1.6em; }
table { border-collapse: collapse; width: 100%; }
th, td { padding: 2px 8px; text-align: left; white-space: nowrap; }
th { border-bottom: 2px solid #888; position: sticky; top: 0; background: #fff; }
tr.f:nth-child(4n+1), tr.f:nth-child(4n+2) { background: #f4f6fa; }
td.data { font-family: ui-monospace, monospace; white-space: normal;
          word-break: break-all; max-width: 48em; }
td.num { text-align: right; font-variant-numeric: tabular-nums; }
.tech-A { color: #0b5394; } .tech-B { color: #38761d; }
.tech-F { color: #b45f06; } .tech-V { color: #741b47; }
.tech-ISO { color: #134f5c; }
.flag { background: #fdd; border-radius: 3px; padding: 0 4px; margin-left: 4px; }
.resp { color: #666; }
details.tree { margin: 2px 0 6px 1em; }
ul.tree, ul.tree ul { list-style: none; margin: 0; padding-left: 1.2em;
                      border-left: 1px dotted #bbb; }
ul.tree .nm { font-weight: 600; }
ul.tree .dt { font-family: ui-monospace, monospace; color: #444; }
svg.wave { width: 100%; height: 120px; background: #fbfbfe;
           border: 1px solid #ddd; }
.fr-span { fill: #0b539422; stroke: #0b5394; stroke-width: .5; }
.fr-span.listen { fill: #38761d22; stroke: #38761d; }
.summary td { padding-right: 2em; }
img.waterfall { width: 100%; height: 220px; image-rendering: pixelated;
                border: 1px solid #ddd; display: block; }
"""


def _tech_label(tech: int) -> tuple[str, str]:
    names = {
        FrameTech.NfcATech: ("NFC-A", "tech-A"),
        FrameTech.NfcBTech: ("NFC-B", "tech-B"),
        FrameTech.NfcFTech: ("NFC-F", "tech-F"),
        FrameTech.NfcVTech: ("NFC-V", "tech-V"),
        FrameTech.Iso7816Tech: ("ISO7816", "tech-ISO"),
    }
    return names.get(tech, (hex(tech), ""))


def _event_name(f: Frame, annotated_command: str | None) -> str:
    if annotated_command:
        return annotated_command
    try:
        return FrameType(f.frame_type).name
    except ValueError:
        return hex(f.frame_type)


def _flags_html(f: Frame) -> str:
    out = []
    for bit, label in _FLAG_NAMES:
        if f.frame_flags & bit:
            out.append(f'<span class="flag">{label}</span>')
    return "".join(out)


def _tree_html(node: dict) -> str:
    nm = html.escape(str(node.get("name", "")))
    dt = node.get("data")
    flags = node.get("flags") or []
    parts = [f'<li><span class="nm">{nm}</span>']
    if dt:
        parts.append(f' <span class="dt">{html.escape(str(dt))}</span>')
    for fl in flags:
        parts.append(f' <span class="flag">{html.escape(str(fl))}</span>')
    children = node.get("children") or []
    if children:
        parts.append("<ul>")
        parts.extend(_tree_html(c) for c in children)
        parts.append("</ul>")
    parts.append("</li>")
    return "".join(parts)


def _wave_svg(stream, frames: list[Frame], width=1200, height=120) -> str:
    """SVG polyline of an adaptive (offset, value) stream with frame spans.
    Adaptive points are step-rendered (each value holds until the next
    offset, matching the resampler's semantics) and bucketed to <= 2*width
    points via min/max decimation so huge captures stay small."""
    offs, vals = stream.offsets, stream.values
    if len(offs) < 2:
        return ""
    lo, hi = int(offs[0]), int(offs[-1])
    span = max(1, hi - lo)
    vmax = float(np.max(vals)) or 1.0
    vmin = min(0.0, float(np.min(vals)))
    vr = (vmax - vmin) or 1.0

    def sx(o):
        return (o - lo) / span * width

    def sy(v):
        return height - 4 - (v - vmin) / vr * (height - 12)

    # min/max bucket decimation
    nb = min(2 * width, len(offs))
    edges = np.linspace(0, len(offs), nb + 1).astype(np.int64)
    pts = []
    for i in range(nb):
        a, b = edges[i], edges[i + 1]
        if a >= b:
            continue
        seg_o, seg_v = offs[a:b], vals[a:b]
        jmin, jmax = int(np.argmin(seg_v)), int(np.argmax(seg_v))
        for j in sorted({0, jmin, jmax, len(seg_v) - 1}):
            pts.append(f"{sx(seg_o[j]):.1f},{sy(seg_v[j]):.1f}")
    poly = " ".join(pts)

    spans = []
    for f in frames:
        if f.frame_type in _CARRIER_TYPES or f.sample_end <= f.sample_start:
            continue
        if f.sample_end < lo or f.sample_start > hi:
            continue
        x0, x1 = sx(f.sample_start), sx(f.sample_end)
        cls = "fr-span listen" if f.frame_type in (
            int(FrameType.NfcListenFrame), int(FrameType.IsoResponseFrame),
        ) else "fr-span"
        spans.append(
            f'<rect class="{cls}" x="{x0:.1f}" y="2" '
            f'width="{max(x1 - x0, 1.0):.1f}" height="{height - 4}"/>'
        )

    dur = span / stream.sample_rate if stream.sample_rate else 0
    return (
        f'<h2>{stream.kind} stream {stream.stream_id} '
        f'({stream.sample_rate / 1e6:.3g} MS/s, {dur:.3f} s)</h2>'
        f'<svg class="wave" viewBox="0 0 {width} {height}" '
        f'preserveAspectRatio="none">'
        + "".join(spans)
        + f'<polyline fill="none" stroke="#333" stroke-width="0.7" '
          f'points="{poly}"/></svg>'
    )


def _png_base64(img: np.ndarray) -> str:
    """Encode an [H, W, 3] uint8 image as a base64 PNG (stdlib only)."""
    import base64
    import struct
    import zlib

    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    return base64.b64encode(png).decode()


# compact blue->yellow power colormap (dark = quiet)
_CMAP = np.stack(
    [
        np.clip(np.linspace(-0.5, 1.5, 256), 0, 1) * 255,          # R
        np.clip(np.linspace(-0.2, 1.2, 256), 0, 1) * 230,          # G
        np.clip(np.linspace(0.25, -0.9, 256) + 0.45, 0, 1) * 255,  # B
    ],
    axis=1,
).astype(np.uint8)


def _spectrum_html(name: str, samples: np.ndarray, sample_rate: int,
                   nfft: int = 1024, max_rows: int = 220,
                   width: int = 1200) -> str:
    """Waterfall + average spectrum for one capture — the static artifact of
    the reference GUI's frequencyView (FourierProcessTask's 1024-point FFT,
    FourierProcessTask.cpp:174-178).  Computed with numpy (the live
    FourierTask runs the same transform on the device)."""
    x = np.asarray(samples, dtype=np.float32).reshape(-1)
    if len(x) < nfft:
        return ""
    hop = max(nfft, int(np.ceil(len(x) / max_rows / nfft)) * nfft)
    starts = np.arange(0, len(x) - nfft + 1, hop)
    window = np.hamming(nfft).astype(np.float32)
    segs = np.stack([x[s:s + nfft] for s in starts]) * window
    power = np.abs(np.fft.rfft(segs, axis=1))[:, 1:]  # drop DC
    db = 20 * np.log10(power + 1e-9)
    lo, hi = np.percentile(db, 5), np.percentile(db, 99.5)
    norm = np.clip((db - lo) / max(hi - lo, 1e-6), 0, 1)
    img = _CMAP[(norm * 255).astype(np.uint8)]
    png = _png_base64(img)

    avg = db.mean(axis=0)
    a0, a1 = float(avg.min()), float(avg.max())
    ar = max(a1 - a0, 1e-6)
    pts = " ".join(
        f"{i / (len(avg) - 1) * width:.1f},{118 - (v - a0) / ar * 112:.1f}"
        for i, v in enumerate(avg)
    )
    ny = sample_rate / 2 / 1e6
    dur = len(x) / sample_rate
    return (
        f"<h2>spectrum — {html.escape(name)} "
        f"(0–{ny:.3g} MHz, {dur:.3f} s, {len(starts)} slices)</h2>"
        f'<img class="waterfall" src="data:image/png;base64,{png}" '
        f'alt="waterfall"/>'
        f'<svg class="wave" viewBox="0 0 {width} 120" '
        f'preserveAspectRatio="none">'
        f'<polyline fill="none" stroke="#0b5394" stroke-width="0.8" '
        f'points="{pts}"/></svg>'
    )


def capture_sections(name: str, samples: np.ndarray, sample_rate: int,
                     frames: list[Frame]) -> str:
    """Spectrum + wave strips for raw capture samples (decode_cli run --html
    path, where the dense signal is available rather than TRZ adaptive
    streams).  Multi-channel captures are logic probes: one wave strip per
    probe, no spectrum."""
    from ..dsp.resample import resample_logic, resample_radio
    from ..io.trz import SignalStream

    samples = np.asarray(samples, np.float32)
    if samples.ndim == 2 and samples.shape[1] > 1:
        out = ""
        for ch, (vals, offs) in resample_logic(
            samples, skip_clk=False
        ).items():
            stream = SignalStream(
                ch, sample_rate, f"logic — {name} probe",
                offsets=np.asarray(offs).astype(np.int64),
                values=np.asarray(vals, np.float32),
            )
            out += _wave_svg(stream, frames)
        return out
    out = _spectrum_html(name, samples, sample_rate)
    vals, offs = resample_radio(samples.reshape(-1))
    stream = SignalStream(
        0, sample_rate, f"radio — {name}",
        offsets=offs.astype(np.int64), values=vals,
    )
    out += _wave_svg(stream, frames)
    return out


def render_html(frames: list[Frame], signals=(), title="nfclab trace",
                extra_sections: str = "") -> str:
    """Render frames (+ optional SignalStreams) to a standalone HTML page."""
    annotated = annotate_frames(frames)

    techs: dict[str, int] = {}
    for f in frames:
        if f.frame_type in _CARRIER_TYPES:
            continue
        techs[_tech_label(f.tech_type)[0]] = (
            techs.get(_tech_label(f.tech_type)[0], 0) + 1
        )
    t0 = min((f.time_start for f in frames), default=0.0)
    t1 = max((f.time_end for f in frames), default=0.0)

    rows = []
    prev_time = None
    fid = 0
    for f, ann in zip(frames, annotated):
        if f.frame_type in _CARRIER_TYPES:
            prev_time = f.time_start
            continue
        fid += 1
        delta = "" if prev_time is None else f"{f.time_start - prev_time:+.6f}"
        prev_time = f.time_start
        tech, cls = _tech_label(f.tech_type)
        event = _event_name(f, ann.get("command"))
        is_resp = f.frame_type in (
            int(FrameType.NfcListenFrame), int(FrameType.IsoResponseFrame),
        )
        rate = f"{f.frame_rate // 1000}k" if f.frame_rate else ""
        tree = ann.get("tree")
        tree_html = (
            f'<tr><td></td><td colspan="7"><details class="tree" open>'
            f"<summary>detail</summary><ul class=\"tree\">{_tree_html(tree)}"
            f"</ul></details></td></tr>"
            if tree
            else '<tr style="display:none"><td colspan="8"></td></tr>'
        )
        rows.append(
            f'<tr class="f{" resp" if is_resp else ""}">'
            f'<td class="num">{fid}</td>'
            f'<td class="num">{f.time_start:.6f}</td>'
            f'<td class="num">{delta}</td>'
            f'<td class="num">{rate}</td>'
            f'<td class="{cls}">{tech}</td>'
            f"<td>{html.escape(event)}</td>"
            f"<td>{_flags_html(f)}</td>"
            f'<td class="data">{html.escape(f.hex_data)}</td></tr>'
            + tree_html
        )

    waves = "".join(_wave_svg(s, frames) for s in signals)
    summary = "".join(
        f"<td><b>{n}</b> {html.escape(t)}</td>" for t, n in sorted(techs.items())
    )

    return f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>{_CSS}</style></head><body>
<h1>{html.escape(title)}</h1>
<table class="summary"><tr>
<td>{fid} frames</td><td>{t1 - t0:.3f} s</td>{summary}
</tr></table>
{waves}
{extra_sections}
<h2>Frames</h2>
<table>
<tr><th>#</th><th>Time</th><th>Delta</th><th>Rate</th><th>Tech</th>
<th>Event</th><th>Flags</th><th>Data</th></tr>
{"".join(rows)}
</table>
<p style="color:#888">generated by nfclab &middot; frames JSON embedded below</p>
<script type="application/json" id="frames-json">
{json.dumps([{k: v for k, v in a.items() if k != "tree"} for a in annotated])}
</script>
</body></html>
"""
