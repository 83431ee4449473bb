"""Experiments of the port: probes that measure one property of the card.

``coissue``: can a latency-bound chain of dependent scalar loads hide behind
throughput-bound slab work inside one kernel?  The counterpart of the JAX
repository's ``experiments/coissue.py``.
"""
