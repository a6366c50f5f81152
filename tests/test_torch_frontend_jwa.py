"""The JWA frontend (``web/jupyter/static/app.js`` and the shared
``kubeflow.js``) executed in the port's JS runtime against the port's
backend, admission chain and controllers (``testing.jsweb``): every case
of tests/test_frontend_exec_jwa.py that names no accelerator runs again
on the port. Its accelerator cases are rewritten on the GPU slice picker
in tests/test_torch_frontend_gpu.py.
"""

import pytest

from torch_control import fixtures_of, ported, run_case, spa

from kubeflow_tpu_torch.web.jupyter import create_app as create_jwa

REFERENCE_CASES = ported("test_frontend_exec_jwa.py")
# The reference's cases that name the accelerator: rewritten in
# tests/test_torch_frontend_gpu.py.
ACCELERATOR_CASES = {
    "test_a11y_focus_trap_and_row_arrows", "test_a11y_table_and_tabs_semantics",
    "test_advanced_env_chips_flow_into_payload",
    "test_create_via_form_submits_real_post",
    "test_details_drawer_tabs_fetch_real_routes",
    "test_env_tab_groups_tpu_variables", "test_help_popover_toggles",
    "test_multislice_spawn_from_form",
    "test_page_loads_and_renders_empty_table"}
CASES = sorted(k for k, v in REFERENCE_CASES.items()
               if k.startswith("test_") and callable(v)
               and k not in ACCELERATOR_CASES)


def test_every_reference_case_is_collected():
    assert len(CASES) == 19
    assert ACCELERATOR_CASES < set(REFERENCE_CASES)
    assert REFERENCE_CASES["JsWebHarness"].__module__ == \
        "kubeflow_tpu_torch.testing.jsweb"


@pytest.fixture()
def jwa():
    with spa(create_jwa) as h:
        yield h


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case, request):
    fn = REFERENCE_CASES[case]
    run_case(fn, **fixtures_of(request, fn))
