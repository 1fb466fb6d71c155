"""One reader a per-layer metric, in ``<metric>.py``: ``read(rec)`` returns
the metric from the traced run's record, or None when the run has nothing
for it to read.  ``rec`` holds the harness's window (``window_s``,
``batch_s``), the trace's reduction (``busy_s``, ``kernels`` {name:
[seconds, launches]}), the card (``n_sm``, ``clock_hz``) and what the
driver recorded (``layer_record``)."""
