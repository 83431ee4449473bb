"""The share of the compress calls' batches after each call's first whose
staging and upload the card hid: the program's own ``EncodeStats.batches``
and ``batches_overlapped`` (``models/fused.py::iter_batches_fused``: a batch
counts where the batch before it still ran when it was uploaded), summed
over the window's compress calls, as 100 x overlapped / (batches - 1), in %.
Read by attribute: None where the program keeps no such counter, or where
no call ran more than one batch."""


def read(run):
    hidden = later = 0
    for c in run.calls_of("compress"):
        batches = getattr(c.stats, "batches", None)
        overlapped = getattr(c.stats, "batches_overlapped", None)
        if batches is None or overlapped is None:
            return None
        hidden += overlapped
        later += max(batches - 1, 0)
    return 100 * hidden / later if later else None
