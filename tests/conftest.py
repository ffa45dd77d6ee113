"""Test harness: force an 8-device CPU platform.

Multi-device behavior is tested on a virtual device mesh via
``xla_force_host_platform_device_count`` (SURVEY.md §4), so the full suite
runs anywhere. Steering must happen before any backend is initialized,
hence the module-level config updates here (conftest imports before all
tests). Tests that need an NVIDIA GPU carry the ``gpu`` marker and skip
here; ``chip_smoke.py`` runs their content on the card.
"""

import functools
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng(request):
    # Function-scoped and seeded from the test name: each test's draws are
    # deterministic AND independent of which other tests ran (a shared
    # session RNG made marginal recall thresholds order-dependent).
    import zlib

    seed = zlib.crc32(request.node.name.encode())  # stable across processes
    return np.random.default_rng(seed)


@pytest.fixture()
def interpret_grouped(monkeypatch):
    """Run the grouped Triton scan kernel under the Pallas interpreter for
    every search path that dispatches to it (the CPU has no Triton)."""
    from cuda_acceleratedvectordatabaseengine.ops import grouped_scan

    monkeypatch.setattr(
        grouped_scan, "scan_probed_lists_grouped",
        functools.partial(grouped_scan.scan_probed_lists_grouped,
                          interpret=True),
    )


@pytest.fixture()
def gpu_device():
    """The first device when it is an NVIDIA GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (content runs in chip_smoke.py)")
    return dev


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu_devices():
    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == 8


def brute_force_oracle(queries, data, k, metric="L2"):
    """NumPy exact ground truth (the recall oracle the reference never built)."""
    q = queries.astype(np.float64)
    x = data.astype(np.float64)
    if metric == "L2":
        d = (
            (q * q).sum(1)[:, None]
            - 2 * q @ x.T
            + (x * x).sum(1)[None, :]
        )
    elif metric == "InnerProduct":
        d = -(q @ x.T)
    elif metric == "Cosine":
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        d = 1 - qn @ xn.T
    else:
        raise ValueError(metric)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx


@pytest.fixture(scope="session")
def oracle():
    return brute_force_oracle


# ---------------------------------------------------------------------------
# Teardown-crash dodge. With enough modules in one process (observed minimal
# trigger: test_pallas_scan + test_server + test_tools), interpreter exit
# aborts INSIDE a third-party C++ thread being force-unwound ("terminate
# called ... FATAL: exception not rethrown", SIGABRT/SIGSEGV) — after every
# test has passed and the summary has printed. All of our own threads are
# joined (native parallel_for) or stopped by fixtures (grpc servers,
# coalescers); the abort comes from grpc-core/XLA-CPU at-exit ordering we
# don't control. Record pytest's real exit status and hard-exit with it
# after unconfigure, so the post-success abort can't corrupt the suite's
# exit code.
_EXIT_STATUS = 0


@pytest.hookimpl(trylast=True)
def pytest_sessionfinish(session, exitstatus):
    global _EXIT_STATUS
    _EXIT_STATUS = int(exitstatus)


@pytest.hookimpl(trylast=True)
def pytest_unconfigure(config):
    import sys

    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(_EXIT_STATUS)
