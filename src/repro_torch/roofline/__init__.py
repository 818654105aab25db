"""Roofline tooling (port of ``repro/roofline``): the term math and the
H100's peaks (``analysis``), and the trace counter that stands in for
the reference's HLO analyzer (``trace_analyzer``)."""
