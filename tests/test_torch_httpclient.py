"""The port's wire client and its flow control behave as the reference's:
every case of tests/test_httpclient.py (``HttpKube`` against a scripted
apiserver: GVR paths, merge patch, the status subresource, the 409 reason,
chunked watch lines, ERROR events, resourceVersion continuation, timeouts
and 429 with Retry-After), the ``FlowControl`` lane cases of
tests/test_latency_hiding.py and the ``BudgetedClient`` / QPS cases of
tests/test_sharding.py run again with their imports pointed at
``kubeflow_tpu_torch``, asserts unchanged.
"""

import pytest

from torch_control import ported, run_case

SOURCES = {
    "test_httpclient.py": None,                 # every case
    "test_latency_hiding.py": (
        "test_flow_control_write_lane_caps_in_flight",
        "test_event_lane_queues_behind_cr_write_burst",
        "test_event_lane_patience_bounds_deference",
        "test_event_lane_admits_when_writes_idle"),
    "test_sharding.py": (
        "test_budgeted_client_paces_reads_to_qps",
        "test_unbudgeted_flowcontrol_does_not_pace"),
}
MODULES = {name: ported(name) for name in SOURCES}
CASES = [(name, case) for name, picked in SOURCES.items()
         for case in (picked or sorted(
             k for k, v in MODULES[name].items()
             if k.startswith("test_") and callable(v)))]


def test_every_reference_case_is_collected():
    assert len([c for c in CASES if c[0] == "test_httpclient.py"]) == 12
    assert len(CASES) == 18
    for name, case in CASES:
        assert callable(MODULES[name][case]), case
    assert MODULES["test_httpclient.py"]["HttpKube"].__module__ == \
        "kubeflow_tpu_torch.runtime.httpclient"
    for name in ("test_latency_hiding.py", "test_sharding.py"):
        assert MODULES[name]["FlowControl"].__module__ == \
            "kubeflow_tpu_torch.runtime.flowcontrol"


@pytest.mark.parametrize("source,case", CASES,
                         ids=[f"{s[5:-3]}::{c}" for s, c in CASES])
def test_reference_case_on_the_port(source, case):
    run_case(MODULES[source][case])


def test_the_fallback_address_is_the_local_proxy(monkeypatch):
    """Without an in-cluster ServiceAccount the client talks to
    ``kubectl proxy``'s address, as the reference's does."""
    from kubeflow_tpu_torch.runtime.httpclient import HttpKube

    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    assert HttpKube().base_url == "http://127.0.0.1:8001"
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    assert HttpKube().base_url == "https://10.0.0.1:6443"
