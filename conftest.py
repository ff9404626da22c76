"""Loads the test suite's plugin, ``tests/suite.py`` (one torch thread, the
``slow`` tests, every test's time limit), for every pytest run in the
repository.  ``tests/conftest.py`` holds the JAX package's test set-up."""

pytest_plugins = ["tests.suite"]
