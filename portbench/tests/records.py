"""Synthetic records for reader tests: a metric's reader loaded from its
file, spans from ``(name, start s, end s)`` rows and a device trace from
``(category, launch s, duration s)`` rows."""

from __future__ import annotations

import os

import numpy as np

from portbench import devtrace, harness
from portbench.tests.helpers import ROOT


def reader(name):
    return harness.load_module(
        os.path.join(ROOT, "portbench", "metrics", name + ".py"), name)


def spans(rows):
    """Spans from ``(name, start s, end s)`` rows on the main thread."""
    sp = devtrace.Spans()
    sp.add_tracer_events([{"ph": "X", "name": n, "ts_us": t0 * 1e6,
                           "dur_us": (t1 - t0) * 1e6, "thread": "main"}
                          for n, t0, t1 in rows], epoch=0.0)
    return sp


def device_trace(ops):
    """A device trace of ``(category, launch s, duration s)`` rows."""
    tr = devtrace.Trace.__new__(devtrace.Trace)
    tr.cat = np.array([c for c, _, _ in ops], dtype=object)
    tr.name = [f"op{i}" for i in range(len(ops))]
    tr.launch = np.array([t for _, t, _ in ops], dtype=float)
    tr.start = tr.launch + 1e-4
    tr.dur = np.array([d for _, _, d in ops], dtype=float)
    tr.is_kernel = tr.cat == "kernel"
    return tr
