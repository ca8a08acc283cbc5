"""Live monitor: the headless equivalent of the reference GUI's real-time
views, served from the stream bus as a single-page web app.

Covers the live-monitoring capability of app-qt (out-of-scope Qt shell,
in-scope capability): the rolling decoded-frame table with the StreamModel
columns Id/Time/Delta/Rate/Tech/Event/Flags/Data (StreamModel.h:55-58), the
live spectrum from ``signal.fft`` (FourierProcessTask's ~100 fps stream),
and every task's retained ``*.status`` subject with throughput.

``MonitorServer`` subscribes to the bus and serves:
  /        one-page view (frame table + spectrum + status chips), polling
  /data    JSON snapshot {frames, spectrum, status}

Wire it into a live pipeline with ``decode_cli live ... --monitor PORT``.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..core.frame import FrameFlags, FrameType
from ..runtime.subject import Subject

_TECHS = {
    0x0101: "NfcA", 0x0102: "NfcB", 0x0103: "NfcF", 0x0104: "NfcV",
    0x0100: "NFC", 0x0201: "ISO7816", 0x0200: "ISO",
}
_EVENTS = {
    int(FrameType.NfcCarrierOn): "CarrierOn",
    int(FrameType.NfcCarrierOff): "CarrierOff",
    int(FrameType.NfcPollFrame): "Poll",
    int(FrameType.NfcListenFrame): "Listen",
    int(FrameType.IsoATRFrame): "ATR",
    int(FrameType.IsoRequestFrame): "Request",
    int(FrameType.IsoResponseFrame): "Response",
    int(FrameType.IsoExchangeFrame): "Exchange",
}
_FLAG_NAMES = (
    (FrameFlags.CrcError, "crc"),
    (FrameFlags.ParityError, "parity"),
    (FrameFlags.SyncError, "sync"),
    (FrameFlags.Truncated, "trunc"),
    (FrameFlags.Encrypted, "enc"),
)


class MonitorState:
    """Bus-fed rolling snapshot: frames ring + latest spectrum + statuses."""

    def __init__(self, max_frames: int = 256, spectrum_bins: int = 512,
                 wave_points: int = 2048):
        self.max_frames = max_frames
        self.spectrum_bins = spectrum_bins
        self._lock = threading.Lock()
        self._frames: deque = deque(maxlen=max_frames)
        self._count = 0
        self._prev_time = None
        self._spectrum: list | None = None
        self._spectrum_rate = 0
        # rolling waterfall (GUI frequencyView role): u8-quantized rows,
        # newest last; fixed dB window over the linear FFT magnitudes
        self._wf_bins = 128
        self._wf_floor, self._wf_ceil = -70.0, 46.0
        self._waterfall: deque = deque(maxlen=180)
        # rolling wave strips from the adaptive render stream
        # (SignalResamplingTask parity: value+offset pairs); logic probes
        # render as one digital lane per channel
        self._wave: deque = deque(maxlen=wave_points)
        self._wave_rate = 0
        self._logic_wave: dict[int, deque] = {}
        # per-frame protocol detail trees (the GUI's ParserNfcA/B/F/V +
        # ISO7816 inspect view): the parser is stateful (selection chains,
        # exchange pairing), so frames feed it in arrival order and a
        # stream-boundary sentinel resets it like a new capture session
        from ..protocol.parser import ProtocolParser

        self._parser = ProtocolParser()
        self._unsubs = [
            Subject.name("radio.decoder.frame").subscribe(
                self._on_frame, replay=False
            ),
            Subject.name("logic.decoder.frame").subscribe(
                self._on_frame, replay=False
            ),
            Subject.name("signal.fft").subscribe(
                self._on_fft, replay=False
            ),
            Subject.name("adaptive.signal").subscribe(
                self._on_wave, replay=False
            ),
            # trace replay (monitor "open trace" -> TraceReplayTask
            # republishes a saved TRZ's frames + adaptive streams, the
            # QtControl open-file role, TraceStorageTask.cpp:258-320)
            Subject.name("storage.frame").subscribe(
                self._on_frame, replay=False
            ),
            Subject.name("storage.signal").subscribe(
                self._on_wave, replay=False
            ),
        ]

    def close(self):
        for u in self._unsubs:
            u()

    def _on_frame(self, frame):
        with self._lock:
            if frame is None:  # stream boundary sentinel: new session
                self._parser.reset()
                return
            try:
                node = self._parser.parse(frame)
                detail = node.to_json() if node is not None else None
            except Exception:
                detail = None
            self._count += 1
            delta = (
                frame.time_start - self._prev_time
                if self._prev_time is not None else 0.0
            )
            self._prev_time = frame.time_start
            flags = [n for f, n in _FLAG_NAMES if frame.has_flags(f)]
            self._frames.append({
                "id": self._count,
                "time": round(frame.time_start, 6),
                "time_end": round(frame.time_end, 6),
                "delta": round(delta, 6),
                "rate": int(frame.frame_rate),
                "tech": _TECHS.get(int(frame.tech_type), "?"),
                "event": _EVENTS.get(int(frame.frame_type), "?"),
                "flags": flags,
                "data": frame.data.hex(":") if frame.data else "",
                "detail": detail,
            })

    def _on_fft(self, buf):
        if buf is None or not getattr(buf, "valid", False):
            return
        mag = np.asarray(buf.data, np.float32).reshape(-1)
        k = max(1, len(mag) // self.spectrum_bins)
        if k > 1:
            mag = mag[: (len(mag) // k) * k].reshape(-1, k).max(axis=1)
        # waterfall row: coarser bins, quantized to u8 over a fixed dB
        # span (the GUI's QuantizeView role) so rows serialize compactly
        wk = max(1, len(mag) // self._wf_bins)
        row = mag[: (len(mag) // wk) * wk].reshape(-1, wk).max(axis=1)
        db = 20.0 * np.log10(row + 1e-9)
        q = np.clip((db - self._wf_floor) *
                    (255.0 / (self._wf_ceil - self._wf_floor)), 0, 255)
        with self._lock:
            self._spectrum = [round(float(v), 4) for v in mag]
            self._spectrum_rate = int(buf.sample_rate)
            self._waterfall.append(q.astype(np.uint8).tolist())

    def _on_wave(self, buf):
        if buf is None or not getattr(buf, "valid", False):
            return
        from ..hw.signal import SignalType

        data = np.asarray(buf.data, np.float32)
        if data.ndim != 2 or data.shape[1] != 2 or not len(data):
            return
        # adaptive pairs are (value, offset-within-block); make absolute
        # seconds, cap points per block so bursts don't flush the window
        vals = data[:, 0]
        offs = data[:, 1] + buf.offset
        k = max(1, len(vals) // 256)
        rate = buf.sample_rate or 1
        pts = [
            (round(float(o) / rate, 6), round(float(v), 4))
            for o, v in zip(offs[::k], vals[::k])
        ]
        with self._lock:
            if buf.signal_type == SignalType.SIGNAL_TYPE_LOGIC_SIGNAL:
                # one digital lane per probe (the GUI's logicView role)
                lane = self._logic_wave.get(buf.stream_id)
                if lane is None:
                    lane = self._logic_wave[buf.stream_id] = deque(
                        maxlen=1024
                    )
                lane.extend(pts)
            else:
                self._wave.extend(pts)
            self._wave_rate = int(buf.sample_rate)

    def snapshot(self) -> dict:
        status = {}
        for name, subj in Subject.registry_items():
            if name.endswith(".status"):
                v = subj.value
                if isinstance(v, dict):
                    status[name[: -len(".status")]] = v
        with self._lock:
            return {
                "frames": list(self._frames),
                "total_frames": self._count,
                "spectrum": self._spectrum,
                "spectrum_rate": self._spectrum_rate,
                "waterfall": list(self._waterfall),
                "wave": list(self._wave),
                "logic_wave": {
                    ch: list(lane)
                    for ch, lane in sorted(self._logic_wave.items())
                },
                "status": status,
            }


# single-series spectrum (no legend needed), neutral dark surface, text in
# ink tokens (never the series color), recessive grid, hover crosshair with
# a tooltip; the frame table IS the table view
_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>nfclab live monitor</title>
<style>
:root { --surface:#16181d; --panel:#1e2127; --ink:#e8eaed; --ink2:#9aa0a6;
        --muted:#5f6368; --series:#7cacf8; --grid:#2a2e36; }
body { background:var(--surface); color:var(--ink);
       font:13px/1.5 system-ui,sans-serif; margin:16px; }
h1 { font-size:15px; font-weight:600; margin:0 0 12px; }
.row { display:flex; gap:16px; flex-wrap:wrap; }
.panel { background:var(--panel); border-radius:8px; padding:12px;
         margin-bottom:16px; }
.status { display:flex; gap:8px; flex-wrap:wrap; }
.chip { background:var(--surface); border-radius:6px; padding:4px 10px;
        color:var(--ink2); }
.chip b { color:var(--ink); font-weight:600; }
table { border-collapse:collapse; width:100%; }
th { text-align:left; color:var(--ink2); font-weight:500; padding:2px 10px;
     border-bottom:1px solid var(--grid); position:sticky; top:0;
     background:var(--panel); }
td { padding:2px 10px; border-bottom:1px solid var(--grid);
     font-variant-numeric:tabular-nums; white-space:nowrap; }
td.data { font-family:ui-monospace,monospace; color:var(--ink);
          white-space:normal; word-break:break-all; }
#tablewrap { max-height:45vh; overflow-y:auto; }
#spec { width:100%; height:180px; display:block; }
#tip { position:absolute; display:none; background:var(--surface);
       color:var(--ink); border:1px solid var(--grid); border-radius:6px;
       padding:4px 8px; pointer-events:none; }
.empty { color:var(--muted); padding:18px; text-align:center; }
tr.exp { cursor:pointer; }
tr.exp:hover td { background:var(--surface); }
td.tree { font-family:ui-monospace,monospace; white-space:normal; }
.ctl { background:var(--surface); color:var(--ink);
       border:1px solid var(--grid); border-radius:6px; padding:5px 14px;
       cursor:pointer; }
.ctl:hover { border-color:var(--series); }
.node { padding:1px 0; }
.kids { margin-left:18px; border-left:1px solid var(--grid);
        padding-left:10px; }
.nname { color:var(--ink); }
.ndata { color:var(--series); }
.nflags { color:#f28b82; }
</style></head><body>
<h1>nfclab live monitor</h1>
<div class="panel"><div class="status" id="status"></div></div>
<div class="panel"><div style="color:var(--ink2);margin-bottom:6px">
Acquisition control</div>
<div style="display:flex;gap:8px;flex-wrap:wrap;align-items:center">
<button id="btnstart" class="ctl">Start</button>
<button id="btnstop" class="ctl">Stop</button>
<button id="btnclear" class="ctl">Clear</button>
<span style="color:var(--muted)">|</span>
<input id="cfgjson" placeholder='decoder config merge-patch, e.g. {"protocol":{"nfca":{"correlationThreshold":0.6}}}'
 style="flex:1;min-width:340px;background:var(--surface);color:var(--ink);
 border:1px solid var(--grid);border-radius:6px;padding:5px 10px"/>
<button id="btncfg" class="ctl">Configure</button>
<span style="color:var(--muted)">|</span>
<input id="trzname" placeholder="trace file, e.g. /tmp/capture.trz"
 style="min-width:200px;background:var(--surface);color:var(--ink);
 border:1px solid var(--grid);border-radius:6px;padding:5px 10px"/>
<input id="trzrange" placeholder="start:end (samples, optional)"
 style="width:170px;background:var(--surface);color:var(--ink);
 border:1px solid var(--grid);border-radius:6px;padding:5px 10px"/>
<button id="btnsave" class="ctl">Save trace</button>
<span style="color:var(--muted)">|</span>
<input id="trzopen" placeholder="open trace file, e.g. /tmp/capture.trz"
 style="min-width:200px;background:var(--surface);color:var(--ink);
 border:1px solid var(--grid);border-radius:6px;padding:5px 10px"/>
<button id="btnopen" class="ctl">Open trace</button>
<span id="ctlmsg" style="color:var(--ink2)"></span>
</div></div>
<div class="panel"><div style="color:var(--ink2);margin-bottom:6px">
Spectrum (dB, full span)</div>
<svg id="spec" preserveAspectRatio="none"></svg><div id="tip"></div>
<div style="color:var(--ink2);margin:8px 0 6px">Waterfall (trailing
frames, newest at bottom)</div>
<canvas id="wf" style="width:100%;height:140px;display:block;
image-rendering:pixelated;border-radius:4px"></canvas></div>
<div class="panel"><div style="color:var(--ink2);margin-bottom:6px">
Signal (adaptive render stream, trailing window) —
<span style="color:var(--muted)">wheel zoom &middot; drag pan &middot;
click cursors &middot; dblclick reset</span>
<span id="wreadout" style="float:right;color:var(--ink)"></span></div>
<svg id="wave" preserveAspectRatio="none" style="width:100%;height:120px;
display:block;cursor:crosshair"></svg>
<div id="lanes"></div></div>
<div class="panel">
<div style="margin-bottom:8px">
<input id="filter" type="search" placeholder="filter frames… (tech, event, flag or hex data)"
 style="width:320px;background:var(--surface);color:var(--ink);
 border:1px solid var(--grid);border-radius:6px;padding:5px 10px"/>
</div>
<div id="tablewrap"><table>
<thead><tr><th>Id</th><th>Time</th><th>Delta</th><th>Rate</th><th>Tech</th>
<th>Event</th><th>Flags</th><th>Data</th></tr></thead>
<tbody id="frames"><tr><td colspan="8" class="empty">waiting for frames…
</td></tr></tbody></table></div></div>
<script>
const fmt = (x, d) => Number(x).toFixed(d);
// ---- acquisition control (QtControl DecoderControlEvent role): POST to
// the task command plane; Start/Stop fan out to every live acquisition +
// decoder task present in the status chips
let lastData = null;
async function postCmd(subject, code, params) {
  const r = await fetch('/command', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({subject, code, params})});
  return await r.json();
}
function ctlMsg(s) { document.getElementById('ctlmsg').textContent = s; }
async function fanout(code) {
  const present = Object.keys((lastData || {}).status || {});
  const targets = ['radio.receiver', 'radio.decoder', 'logic.receiver',
                   'logic.decoder'].filter(t => present.includes(t));
  if (!targets.length) { ctlMsg('no commandable tasks'); return; }
  const res = [];
  for (const t of targets) {
    const d = await postCmd(t, code);
    res.push(`${t}:${d.ok ? 'ok' : d.error}`);
  }
  ctlMsg(res.join(' '));
}
document.getElementById('btnstart').onclick = () => fanout('start');
document.getElementById('btnstop').onclick = () => fanout('stop');
document.getElementById('btnclear').onclick = () => fanout('clear');
document.getElementById('btncfg').onclick = async () => {
  let patch;
  try { patch = JSON.parse(document.getElementById('cfgjson').value); }
  catch (e) { ctlMsg('bad json: ' + e); return; }
  const target = ('channelMap' in patch) ? 'logic.decoder' : 'radio.decoder';
  const d = await postCmd(target, 'configure', patch);
  ctlMsg(d.ok ? `${target} configured` : d.error);
};
document.getElementById('btnsave').onclick = async () => {
  const name = document.getElementById('trzname').value.trim();
  if (!name) { ctlMsg('trace file name required'); return; }
  const params = {fileName: name};
  const range = document.getElementById('trzrange').value.trim();
  if (range) {
    const [a, b] = range.split(':');
    params.sampleStart = Number(a); params.sampleEnd = Number(b);
  }
  const d = await postCmd('storage', 'configure', params);
  ctlMsg(d.ok ? `trace written: ${name}` : d.error);
};
document.getElementById('btnopen').onclick = async () => {
  const path = document.getElementById('trzopen').value.trim();
  if (!path) { ctlMsg('trace file path required'); return; }
  const r = await fetch('/open', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({path})});
  const d = await r.json();
  ctlMsg(d.ok ? `replaying ${path}` : d.error);
};
let lastSpec = null;
// per-frame protocol detail trees (ParserNfcA/B/F/V + ISO7816 view):
// click a row to expand its parse tree
const expanded = new Set(), details = {};
const framesById = {};
function toggle(id) {
  const f = framesById[id];
  // selecting a row shades the frame's sample span on the signal view
  if (f && f.time_end !== undefined) {
    selSpan = [f.time, Math.max(f.time_end, f.time + 1e-6)];
    if (lastWave) drawWave(lastWave);
  }
  if (!details[id] && !(f && f.data)) return;
  if (expanded.has(id)) expanded.delete(id); else expanded.add(id);
  tickNow();
}
// hex view role (the GUI's frame hex dump): offset | hex | ascii
function hexDump(hexstr) {
  const b = hexstr ? hexstr.split(':') : [];
  if (!b.length) return '';
  let out = '';
  for (let o = 0; o < b.length; o += 16) {
    const row = b.slice(o, o + 16);
    const hex = row.map((x, i) => x + (i === 7 ? ' ' : '')).join(' ');
    const asc = row.map(x => {
      const c = parseInt(x, 16);
      return c >= 32 && c < 127 ? String.fromCharCode(c) : '.';
    }).join('');
    out += `<div><span style="color:var(--muted)">` +
      `${o.toString(16).padStart(4, '0')}</span>  ` +
      `${hex.padEnd(49)}  <span style="color:var(--ink2)">${esc(asc)}` +
      `</span></div>`;
  }
  return `<div style="font-family:ui-monospace,monospace;white-space:pre;` +
    `margin-bottom:6px">${out}</div>`;
}
const esc = s => String(s).replace(/&/g, '&amp;').replace(/</g, '&lt;');
function renderTree(n) {
  const flags = (n.flags || []).length
    ? ` <span class="nflags">[${n.flags.join(' ')}]</span>` : '';
  const data = n.data ? ` <span class="ndata">${esc(n.data)}</span>` : '';
  const kids = (n.children || []).map(renderTree).join('');
  return `<div class="node"><span class="nname">${esc(n.name)}</span>` +
    `${data}${flags}${kids ? `<div class="kids">${kids}</div>` : ''}</div>`;
}
async function tick() {
  try {
    const r = await fetch('/data'); const d = await r.json();
    const st = document.getElementById('status');
    st.innerHTML = Object.entries(d.status).map(([k, v]) => {
      const extra = Object.entries(v).filter(([a]) => a != 'status')
        .map(([a, b]) => `${a}=${b}`).join(' ');
      return `<span class="chip"><b>${k}</b> ${v.status} ${extra}</span>`;
    }).join('') +
      `<span class="chip"><b>frames</b> ${d.total_frames}</span>`;
    lastData = d;
    renderTable(d);
    lastSpec = d.spectrum;
    drawSpec();
    drawWaterfall(d.waterfall || []);
    drawWave(d.wave);
    drawLanes(d.logic_wave || {});
  } catch (e) {}
  setTimeout(tick, 500);
}
// sequential single-hue ramp (dark surface -> series hue -> white) over
// the u8-quantized dB rows; identity is magnitude, so one hue only
function wfColor(v) {
  const t = v / 255;
  if (t < 0.5) { const u = t * 2;
    return [22 + u * (62 - 22), 24 + u * (114 - 24), 29 + u * (196 - 29)]; }
  const u = (t - 0.5) * 2;
  return [62 + u * (255 - 62), 114 + u * (255 - 114), 196 + u * (255 - 196)];
}
function drawWaterfall(rows) {
  const cv = document.getElementById('wf');
  if (!rows.length) { return; }
  const W = rows[0].length, H = rows.length;
  if (cv.width != W || cv.height != H) { cv.width = W; cv.height = H; }
  const ctx = cv.getContext('2d');
  const img = ctx.createImageData(W, H);
  for (let y = 0; y < H; y++) {
    const row = rows[y];
    for (let x = 0; x < W; x++) {
      const [r, g, b] = wfColor(row[x]);
      const o = (y * W + x) * 4;
      img.data[o] = r; img.data[o + 1] = g; img.data[o + 2] = b;
      img.data[o + 3] = 255;
    }
  }
  ctx.putImageData(img, 0, 0);
}
function tickNow() { if (lastData) renderTable(lastData); }
function renderTable(d) {
    const tb = document.getElementById('frames');
    // StreamFilter role: substring match over tech/event/flags/data
    const q = document.getElementById('filter').value.trim().toLowerCase();
    const rows = d.frames.filter(f => !q ||
      `${f.tech} ${f.event} ${f.flags.join(' ')} ${f.data}`
        .toLowerCase().includes(q));
    if (d.frames.length) {
      tb.innerHTML = rows.slice().reverse().map(f => {
        framesById[f.id] = f;
        const hasD = !!f.detail || !!f.data;
        details[f.id] = f.detail;
        const open = expanded.has(f.id) && hasD;
        let h = `<tr class="exp" onclick="toggle(${f.id})">` +
          `<td>${hasD ? (open ? '▾ ' : '▸ ') : ''}${f.id}</td>` +
          `<td>${fmt(f.time, 4)}</td>` +
          `<td>${fmt(f.delta, 4)}</td><td>${f.rate || ''}</td>` +
          `<td>${f.tech}</td><td>${f.event}</td>` +
          `<td>${f.flags.join(' ')}</td><td class="data">${f.data}</td></tr>`;
        if (open) h += `<tr><td></td><td colspan="7" class="tree">` +
          hexDump(f.data) + (f.detail ? renderTree(f.detail) : '') +
          `</td></tr>`;
        return h;
      }).join('') || `<tr><td colspan="8" class="empty">no frames match
        "${q}"</td></tr>`;
    }
}
const LANE_NAMES = {0: 'IO', 1: 'CLK', 2: 'RST', 3: 'VCC'};
function drawLanes(lw) {
  const box = document.getElementById('lanes');
  const chans = Object.keys(lw);
  if (!chans.length) { box.innerHTML = ''; return; }
  box.innerHTML = chans.map(ch => {
    const w = lw[ch];
    if (w.length < 2) return '';
    const W = box.clientWidth || 800, H = 34;
    const t0 = w[0][0], t1 = w[w.length - 1][0], ts = (t1 - t0) || 1;
    // digital step rendering: hold each level until the next change point
    let pts = [];
    for (let i = 0; i < w.length; i++) {
      const x = ((w[i][0] - t0) / ts * W).toFixed(1);
      const y = (w[i][1] > 0.5 ? 5 : H - 5);
      if (i) pts.push(`${x},${pts[pts.length-1].split(',')[1]}`);
      pts.push(`${x},${y}`);
    }
    const name = LANE_NAMES[ch] !== undefined ? LANE_NAMES[ch] : 'CH' + ch;
    return `<div style="display:flex;align-items:center;gap:8px;
      margin-top:4px"><span style="color:var(--ink2);width:34px;
      font-size:11px">${name}</span>
      <svg preserveAspectRatio="none" viewBox="0 0 ${W} ${H}"
        style="flex:1;height:${H}px"><polyline points="${pts.join(' ')}"
        fill="none" stroke="var(--series)" stroke-width="2"/></svg></div>`;
  }).join('');
}
// ---- interactive signal analysis (graph/ time cursors + zoom role):
// wheel zoom around the pointer, drag pan, click places measure cursors
// (two cursors -> dt and 1/dt readout), dblclick resets, selecting a
// frame row shades its [start, end] span
let lastWave = null, waveView = null, cursors = [], selSpan = null;
function waveExtent(w) { return [w[0][0], w[w.length - 1][0]]; }
function drawWave(w) {
  lastWave = w;
  const svg = document.getElementById('wave');
  if (!w || w.length < 2) { svg.innerHTML = ''; return; }
  const W = svg.clientWidth || 800, H = svg.clientHeight || 120;
  svg.setAttribute('viewBox', `0 0 ${W} ${H}`);
  const [f0, f1] = waveExtent(w);
  let v0 = f0, v1 = f1;
  if (waveView) {
    v0 = Math.max(f0, waveView[0]); v1 = Math.min(f1, waveView[1]);
    if (v1 - v0 < 1e-9) { waveView = null; v0 = f0; v1 = f1; }
  }
  const ts = (v1 - v0) || 1;
  const vis = w.filter(p => p[0] >= v0 && p[0] <= v1);
  if (vis.length < 2) { svg.innerHTML = ''; return; }
  const vs = vis.map(p => p[1]);
  const lo = Math.min(...vs), hi = Math.max(...vs), span = (hi - lo) || 1;
  const X = t => (t - v0) / ts * W;
  const pts = vis.map(p =>
    `${X(p[0]).toFixed(1)},` +
    `${(H - 6 - (p[1] - lo) / span * (H - 12)).toFixed(1)}`).join(' ');
  let extra = '';
  if (selSpan && selSpan[1] > v0 && selSpan[0] < v1) {
    const x0 = Math.max(0, X(selSpan[0])), x1 = Math.min(W, X(selSpan[1]));
    extra += `<rect x="${x0.toFixed(1)}" y="0"
      width="${Math.max(1.5, x1 - x0).toFixed(1)}" height="${H}"
      fill="var(--series)" opacity="0.18"/>`;
  }
  for (const c of cursors) {
    if (c < v0 || c > v1) continue;
    extra += `<line x1="${X(c).toFixed(1)}" x2="${X(c).toFixed(1)}"
      y1="0" y2="${H}" stroke="#fdd663" stroke-width="1.5"/>`;
  }
  svg.innerHTML =
    `<line x1="0" x2="${W}" y1="${H / 2}" y2="${H / 2}"
      stroke="var(--grid)" stroke-width="1"/>` + extra +
    `<polyline points="${pts}" fill="none" stroke="var(--series)"
      stroke-width="2"/>` +
    `<line id="wxh" y1="0" y2="${H}" stroke="var(--muted)"
      stroke-width="1" visibility="hidden"/>` +
    `<text x="4" y="${H - 4}" fill="var(--ink2)" font-size="11">
      ${v0.toFixed(4)}s</text>` +
    `<text x="${W - 70}" y="${H - 4}" fill="var(--ink2)" font-size="11">
      ${v1.toFixed(4)}s</text>`;
  const ro = document.getElementById('wreadout');
  if (cursors.length === 2) {
    const dt = Math.abs(cursors[1] - cursors[0]);
    ro.textContent = `\u0394t ${(dt * 1e6).toFixed(1)} \u00b5s` +
      (dt > 0 ? ` (${(1 / dt / 1000).toFixed(2)} kHz)` : '');
  } else if (waveView) {
    ro.textContent = `zoom ${((f1 - f0) / ts).toFixed(1)}\u00d7`;
  } else { ro.textContent = ''; }
}
(function () {
  const svg = document.getElementById('wave');
  let down = null, moved = false;
  const timeAt = ev => {
    const r = svg.getBoundingClientRect();
    const fx = (ev.clientX - r.left) / r.width;
    if (!lastWave || lastWave.length < 2) return null;
    const [f0, f1] = waveExtent(lastWave);
    const v0 = waveView ? Math.max(f0, waveView[0]) : f0;
    const v1 = waveView ? Math.min(f1, waveView[1]) : f1;
    return v0 + fx * (v1 - v0);
  };
  svg.addEventListener('wheel', ev => {
    ev.preventDefault();
    const t = timeAt(ev); if (t === null) return;
    const [f0, f1] = waveExtent(lastWave);
    const v0 = waveView ? waveView[0] : f0, v1 = waveView ? waveView[1] : f1;
    const k = ev.deltaY > 0 ? 1.3 : 1 / 1.3;
    let n0 = t - (t - v0) * k, n1 = t + (v1 - t) * k;
    if (n1 - n0 >= f1 - f0) { waveView = null; }
    else { waveView = [Math.max(f0, n0), Math.min(f1, n1)]; }
    drawWave(lastWave);
  }, { passive: false });
  svg.addEventListener('mousedown', ev => {
    down = [ev.clientX, timeAt(ev)]; moved = false;
  });
  svg.addEventListener('mousemove', ev => {
    const r = svg.getBoundingClientRect();
    if (down && Math.abs(ev.clientX - down[0]) > 3 && lastWave) {
      moved = true;
      const [f0, f1] = waveExtent(lastWave);
      const v0 = waveView ? waveView[0] : f0,
            v1 = waveView ? waveView[1] : f1;
      const dt = (down[0] - ev.clientX) / r.width * (v1 - v0);
      let n0 = v0 + dt, n1 = v1 + dt;
      if (n0 < f0) { n1 += f0 - n0; n0 = f0; }
      if (n1 > f1) { n0 -= n1 - f1; n1 = f1; }
      waveView = [n0, n1]; down[0] = ev.clientX;
      drawWave(lastWave);
      return;
    }
    const t = timeAt(ev); if (t === null) return;
    const xh = document.getElementById('wxh');
    const fx = (ev.clientX - r.left) / r.width * (svg.clientWidth || 800);
    if (xh) { xh.setAttribute('x1', fx); xh.setAttribute('x2', fx);
              xh.setAttribute('visibility', 'visible'); }
    const tip = document.getElementById('tip');
    tip.style.display = 'block';
    tip.style.left = (ev.pageX + 12) + 'px';
    tip.style.top = (ev.pageY - 10) + 'px';
    tip.textContent = `t = ${(t * 1000).toFixed(3)} ms`;
  });
  svg.addEventListener('mouseup', ev => {
    if (down && !moved) {
      const t = timeAt(ev);
      if (t !== null) {
        if (cursors.length >= 2) cursors = [t]; else cursors.push(t);
        drawWave(lastWave);
      }
    }
    down = null;
  });
  svg.addEventListener('mouseleave', () => {
    down = null;
    document.getElementById('tip').style.display = 'none';
    const xh = document.getElementById('wxh');
    if (xh) xh.setAttribute('visibility', 'hidden');
  });
  svg.addEventListener('dblclick', () => {
    waveView = null; cursors = []; drawWave(lastWave);
  });
})();
function drawSpec() {
  const svg = document.getElementById('spec');
  const s = lastSpec;
  if (!s || !s.length) { svg.innerHTML = ''; return; }
  const W = svg.clientWidth || 800, H = svg.clientHeight || 180;
  svg.setAttribute('viewBox', `0 0 ${W} ${H}`);
  const lo = Math.min(...s), hi = Math.max(...s), span = (hi - lo) || 1;
  const pts = s.map((v, i) =>
    `${(i / (s.length - 1) * W).toFixed(1)},` +
    `${(H - 6 - (v - lo) / span * (H - 12)).toFixed(1)}`).join(' ');
  let grid = '';
  for (let g = 1; g < 4; g++)
    grid += `<line x1="0" x2="${W}" y1="${H * g / 4}" y2="${H * g / 4}"
             stroke="var(--grid)" stroke-width="1"/>`;
  svg.innerHTML = grid +
    `<polyline points="${pts}" fill="none" stroke="var(--series)"
      stroke-width="2"/>` +
    `<line id="xh" y1="0" y2="${H}" stroke="var(--muted)"
      stroke-width="1" visibility="hidden"/>`;
}
document.getElementById('spec').addEventListener('mousemove', ev => {
  const s = lastSpec; if (!s || !s.length) return;
  const svg = ev.currentTarget, r = svg.getBoundingClientRect();
  const fx = (ev.clientX - r.left) / r.width;
  const i = Math.max(0, Math.min(s.length - 1,
    Math.round(fx * (s.length - 1))));
  const xh = document.getElementById('xh');
  if (xh) { xh.setAttribute('x1', fx * r.width);
            xh.setAttribute('x2', fx * r.width);
            xh.setAttribute('visibility', 'visible'); }
  const tip = document.getElementById('tip');
  tip.style.display = 'block';
  tip.style.left = (ev.pageX + 12) + 'px';
  tip.style.top = (ev.pageY - 10) + 'px';
  tip.textContent = `bin ${i}: ${fmt(s[i], 2)} dB`;
});
document.getElementById('spec').addEventListener('mouseleave', () => {
  document.getElementById('tip').style.display = 'none';
  const xh = document.getElementById('xh');
  if (xh) xh.setAttribute('visibility', 'hidden');
});
tick();
</script></body></html>
"""


#: task subjects the monitor may command (QtControl.cpp:340-420 routes
#: DecoderControlEvent to exactly the acquisition/decoder/storage workers)
COMMANDABLE = (
    "radio.receiver", "radio.decoder",
    "logic.receiver", "logic.decoder",
    "storage", "recorder", "adaptive", "fourier",
)


def post_command(subject: str, code: str, params: dict | None = None,
                 timeout: float = 5.0):
    """Post an Event on ``<subject>.command`` and wait for settle — the
    monitor's bridge into the existing task control plane
    (AbstractTask Start/Stop/Query/Configure; QtControl.cpp:340-420 role).
    Returns the resolved snapshot; raises on reject/timeout."""
    import threading as _threading

    from ..runtime.subject import Event, Subject as _Subject

    done = _threading.Event()
    out: dict = {}

    def ok(snap=None):
        out["snap"] = snap
        done.set()

    def bad(err=None):
        out["err"] = err
        done.set()

    _Subject.name(f"{subject}.command").next(
        Event(code, params or {}, on_resolve=ok, on_reject=bad)
    )
    if not done.wait(timeout):
        raise TimeoutError(f"{subject} command {code!r} unanswered")
    if "err" in out:
        raise RuntimeError(str(out["err"]))
    return out["snap"]


class MonitorServer:
    """Threaded HTTP server around a MonitorState."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 state: MonitorState | None = None):
        self.state = state or MonitorState()
        monitor = self.state
        monitor_server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] == "/data":
                    body = json.dumps(monitor.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.split("?")[0] == "/":
                    body = _PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802
                """/command {subject, code, params?} -> task command plane
                (Start/Stop/Query/Configure/Clear; trace save = storage
                Configure with fileName, TraceStorageTask.cpp:322-363).
                /open {path} -> replay a saved TRZ into the monitor views
                (TraceReplayTask; the QtControl open-file role)."""
                route = self.path.split("?")[0]
                if route == "/open":
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        req = json.loads(self.rfile.read(n) or b"{}")
                        path = str(req.get("path", ""))
                        if not os.path.isfile(path):
                            raise ValueError(f"no such trace file: {path}")
                        monitor_server._open_trace(path)
                        body = json.dumps({"ok": True}).encode()
                        status = 200
                    except Exception as e:
                        body = json.dumps(
                            {"ok": False, "error": str(e)}
                        ).encode()
                        status = 400
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if route != "/command":
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    subject = str(req.get("subject", ""))
                    code = str(req.get("code", ""))
                    if subject not in COMMANDABLE:
                        raise ValueError(f"uncommandable subject {subject!r}")
                    if code not in ("start", "stop", "query", "configure",
                                    "clear"):
                        raise ValueError(f"unknown command {code!r}")
                    snap = post_command(subject, code, req.get("params"))
                    body = json.dumps({"ok": True, "result": snap}).encode()
                    status = 200
                except Exception as e:
                    body = json.dumps({"ok": False, "error": str(e)}).encode()
                    status = 400
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    def _open_trace(self, path: str) -> None:
        """Replay a saved TRZ into the monitor views via TraceReplayTask
        (QtControl open-file role): frames land in the frame table +
        parser trees, adaptive streams in the wave lanes.  One replay at a
        time; a second open while one runs terminates the first."""
        from ..runtime.pipeline import TraceReplayTask

        prev = getattr(self, "_replay", None)
        if prev is not None:
            prev[0].terminate()
            prev[1].join(timeout=5)
        task = TraceReplayTask(path)
        t = threading.Thread(target=task.run, daemon=True)
        t.start()
        self._replay = (task, t)

    def start(self) -> "MonitorServer":
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self.state.close()
