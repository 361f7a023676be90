"""The benchmark's yardstick: everything that decides a number.

Traffic generation, the FLOP and byte arithmetic, the table of peaks, the
reduction of traces and step events to metrics, the plain reference and
the comparison that decides ``correct``. A model family is a module of
:mod:`.families` and a probed kernel one of :mod:`.probes`, each found by
name. The program under test (``repro_torch``) is reached only through
:mod:`.program`, and its own spans through :mod:`.spans`; nothing else
here imports it.
"""
