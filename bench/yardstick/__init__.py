"""The benchmark's yardstick: everything that decides a number.

Traffic generation, the FLOP and byte arithmetic, the table of peaks, the
reduction of traces and step events to metrics, the plain reference and
the comparison that decides ``correct``. The program under test
(``repro_torch``) is reached only through :mod:`.program`; nothing else
here imports it.
"""
