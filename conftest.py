"""Root test set-up: build the JAX package's native library once, up front.

``lz77_tpu/native.py`` compiles ``native/liblz77host.so`` straight onto its
final path when the file is missing.  Under pytest-xdist every worker asks
for it while collecting, so on a fresh tree one worker can load the file
while another is still writing it, find it unusable, and skip the tests
that need it.  Building it here, in the process that starts the workers and
before they start, leaves them a finished file.  No test is skipped,
selected or changed.

``lz77_tpu.native`` imports no ``jax``, so this leaves ``tests/conftest.py``
free to set JAX's platform before JAX is first imported.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the file exists
        return
    from lz77_tpu import native

    native.available()
