"""Experiments of the port: probes and big-run drivers, each the counterpart
of the JAX repository's module of the same name under ``experiments/``.

``coissue``: can a latency-bound chain of dependent scalar loads hide behind
throughput-bound slab work inside one kernel?  ``multihost_bigrun``: the
multi-process file encode at >= 1 GB over N local ranks.  ``bigrun_r5``:
multi-GB native encode and decodes, each process measuring its own peak
RSS.
"""
