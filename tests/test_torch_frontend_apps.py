"""The VWA, TWA and dashboard frontends and the shared lib's editor,
executed in the port's JS runtime against the port's backends and
controllers: every case of tests/test_frontend_exec_apps.py and
tests/test_frontend_editor.py that names no accelerator runs again on the
port; the accelerator cases (the dashboard's card panel, the
Tensorboards app's profiler hint, the toleration preset) are rewritten on
the GPU.
"""

import pytest

from torch_control import fixtures_of, ported, run_case, spa

from kubeflow_tpu_torch.controllers.profile import setup_profile_controller
from kubeflow_tpu_torch.controllers.tensorboard import \
    setup_tensorboard_controller
from kubeflow_tpu_torch.testing.jsweb import JsWebHarness
from kubeflow_tpu_torch.web.dashboard import create_app as create_dashboard
from kubeflow_tpu_torch.web.jupyter import create_app as create_jwa
from kubeflow_tpu_torch.web.tensorboards import create_app as create_twa
from kubeflow_tpu_torch.web.volumes import create_app as create_vwa

MODULES = {name: ported(name) for name in (
    "test_frontend_exec_apps.py", "test_frontend_editor.py")}
# The reference's cases that name the accelerator: rewritten below.
ACCELERATOR_CASES = {"test_dashboard_locale_switch",
                     "test_dashboard_workgroup_flow_and_panels",
                     "test_twa_create_and_details"}
CASES = sorted(
    (module, name) for module, namespace in MODULES.items()
    for name, fn in namespace.items()
    if name.startswith("test_") and callable(fn)
    and name not in ACCELERATOR_CASES)
APPS = MODULES["test_frontend_exec_apps.py"]


def test_every_reference_case_is_collected():
    assert len(CASES) == 19
    assert {name for module, name in CASES
            if module == "test_frontend_exec_apps.py"} | ACCELERATOR_CASES \
        == {name for name in APPS if name.startswith("test_")}


@pytest.fixture()
def jwa():
    with spa(create_jwa) as h:
        yield h


@pytest.fixture()
def vwa():
    with spa(create_vwa, extra_controllers=(
            APPS["_setup_pvcviewer_with_urls"],)) as h:
        yield h


@pytest.fixture()
def twa():
    with spa(create_twa,
             extra_controllers=(setup_tensorboard_controller,)) as h:
        yield h


@pytest.mark.parametrize("module,case", CASES)
def test_reference_case_on_the_port(module, case, request):
    fn = MODULES[module][case]
    run_case(fn, **fixtures_of(request, fn))


# ---- the accelerator cases, on the GPU ---------------------------------------


def test_twa_create_and_details_names_torch_profiler_traces(twa):
    b = twa.browser
    b.click("#new-btn")
    b.set_value('#new-form input[name="name"]', "profiles")
    b.set_value('#new-form input[name="logspath"]', "gs://bkt/traces")
    b.submit("#new-form")
    tb = twa.kube_get("Tensorboard", "profiles", "team")
    assert tb["spec"]["logspath"] == "gs://bkt/traces"

    twa.poll_ui()
    table = b.text("#tb-table")
    assert "profiles" in table
    assert "GCS bucket (torch.profiler traces)" in table
    row = [el for el in b.query_all("#tb-table tbody tr")
           if "profiles" in el.text_content()][0]
    b.click(row)
    drawer = b.text(".kf-drawer")
    assert "TensorBoard profiles" in drawer
    assert "/tensorboard/team/profiles/" in drawer
    assert "*.pt.trace.json" in drawer and "torch.profiler" in drawer
    # The capture button's files, from the sdk's live profiler server.
    assert "*.xplane.pb" in drawer and "start_profiler_server" in drawer
    assert "XLA" not in drawer and "jax" not in drawer


def _registered_dashboard(h):
    b = h.browser
    b.load("/")
    assert b.query("#register-card").style.props.get("display") == "block"
    b.click("#register-btn")
    h.settle()
    b.advance(10000)
    h.settle()
    b.advance(10000)
    return b


def test_dashboard_workgroup_flow_and_gpu_panel():
    with JsWebHarness(create_dashboard,
                      extra_controllers=(setup_profile_controller,)) as h:
        b = _registered_dashboard(h)
        (profile,) = h.kube_list("Profile")
        assert profile["spec"]["owner"]["name"] == "alice@example.com"
        table = b.text("#ns-table")
        assert "alice" in table and "owner" in table
        assert b.query("#register-card").style.props.get("display") == "none"
        # The card panel loaded for the first namespace.
        assert "0 GPUs requested in alice (no quota)" in b.text("#gpu-table")
        assert "No GPU pods running." in b.text("#gpu-table")
        assert b.query("#tpu-table") is None
        notes = [el.text_content() for el in b.query_all(".metric-note")]
        assert len(notes) == 3
        assert all("metrics" in n or "no data" in n for n in notes)
        assert "GPU duty cycle" in b.text("main")


def test_dashboard_locale_switch_on_the_gpu_panel():
    with JsWebHarness(create_dashboard,
                      extra_controllers=(setup_profile_controller,)) as h:
        b = _registered_dashboard(h)
        assert "My namespaces" in b.text("main")
        b.change("select.kf-locale-picker", "de")
        h.settle()
        b.advance(10000)
        h.settle()
        text = b.text("main")
        assert "Meine Namespaces" in text and "GPU-Nutzung" in text
        table = b.text("#ns-table")
        assert "Verwalten" in table and "Rolle" in table
        assert "GPUs angefordert" in b.text("#gpu-table")
