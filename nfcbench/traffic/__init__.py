"""Traffic: mixes and their generators, found by name.

A mix is ``<mix>.json`` here, a file of parameters whose ``generator``
key names a generator module here, ``<generator>.py``.  A generator
module has

- ``Traffic(mix, seed, n_streams, width, rate)``: the streams of the
  mix drawn from ``seed`` at the configuration's sample rate (it refuses
  a rate it does not write), with ``block(k)`` (the k-th block every
  entry driver hands over), ``width``, ``period`` and ``n_streams``;
- ``judge(frames, traffic, lo, hi, limits)``: the numbers compared for
  one run, from ``frames``, (stream, program frame, whether it came back
  in the window) for every frame the run emitted, and [lo, hi), the
  window's samples of each stream.  They hold ``due``, ``missing`` and
  ``unmatched`` and every number that the cell's limits file names.

A new kind of traffic is a new mix file and, where no generator writes
it, a new generator module beside the others.
"""
