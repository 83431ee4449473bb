"""Device operations (kernels, copies and fills) that started inside the
benchmark's compress spans of the traced window, per compress call."""


def read(run):
    if not run.view:
        return None
    spans = run.view.spans_of("compress")
    if not spans:
        return None
    return len(run.view.ops_in(spans)) / len(spans)
