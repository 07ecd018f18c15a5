"""Build ``dvd_tpu``'s native SIFT-flow library once, before any test
process loads it.

``dvd_tpu.native`` compiles ``_siftflow.so`` with ``g++`` on first use,
writing the library in place, with no lock between processes.  Under
pytest-xdist every worker collects every test file, and
``tests/test_native_siftflow.py`` asks ``native.available()`` while it is
collected: workers that start at once each run ``g++ -o _siftflow.so`` on
the one path, and a worker that loads the file another is still writing
skips all of that file's tests.  So the controlling process (the one
without ``workerinput``) builds the library here, before it starts the
workers, which then find it newer than its source and only load it.
Without ``g++`` the call returns False and the tests skip as before.
"""


def pytest_configure(config):
    if not hasattr(config, "workerinput"):
        from dvd_tpu import native

        native.available()
