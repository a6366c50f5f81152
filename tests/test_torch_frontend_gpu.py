"""The accelerator cases of tests/test_frontend_exec_jwa.py, rewritten on
the port's GPU slice picker: the JWA frontend executed in the port's JS
runtime against the port's backend, admission chain and controllers. The
picker lists the GKE GPU node types from ``/api/gpus``, its choice
becomes ``spec.gpu``, and the row shows ``nvidia-h100-80gb 1x1``.

Three reference cases use a TPU slice only as the data of the notebook
they create (the details drawer and the two a11y flows): they run
unchanged, with ``api.notebook.new`` given the H100 shape of as many
cards (v5e ``2x2`` → ``1x4``, ``2x4`` → ``1x8``).
"""

import pytest

from torch_control import ported, run_case, spa

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.testing.jsrt.dom import Event
from kubeflow_tpu_torch.web.jupyter import create_app as create_jwa

GPU = "nvidia-h100-80gb"
REFERENCE_CASES = ported("test_frontend_exec_jwa.py")
H100_SHAPE = {("v5e", "2x2"): "1x4", ("v5e", "2x4"): "1x8"}
DATA_ONLY_CASES = ("test_a11y_focus_trap_and_row_arrows",
                   "test_a11y_table_and_tabs_semantics",
                   "test_details_drawer_tabs_fetch_real_routes")


@pytest.fixture()
def jwa():
    with spa(create_jwa) as h:
        yield h


def table_text(h) -> str:
    return h.browser.text("#notebook-table")


@pytest.mark.parametrize("case", DATA_ONLY_CASES)
def test_reference_case_on_h100_shapes(case, jwa, monkeypatch):
    new = nbapi.new
    made = []

    def on_h100(name, namespace, *, accelerator=None, topology=None, **kw):
        if accelerator is not None:
            topology = H100_SHAPE[(accelerator, topology)]
            accelerator = GPU
        nb = new(name, namespace, accelerator=accelerator, topology=topology,
                 **kw)
        made.append(nb)
        return nb

    monkeypatch.setattr(nbapi, "new", on_h100)
    run_case(REFERENCE_CASES[case], jwa=jwa)
    assert made and all(nb["spec"]["gpu"]["accelerator"] == GPU
                        for nb in made)


def test_page_loads_with_the_gpu_picker(jwa):
    assert "No notebook servers in this namespace." in table_text(jwa)
    b = jwa.browser
    values = [o.attrs.get("value") for o in b.query_all("#gpu-acc option")]
    assert values == ["", GPU, "nvidia-h100-mega-80gb"]
    assert b.query("#tpu-acc") is None
    b.change("#gpu-acc", GPU)
    shapes = [o.text_content() for o in b.query_all("#gpu-topo option")]
    assert shapes[0] == "1x1 — 1 GPU, 1 node"
    assert shapes[4] == "2x8 — 16 GPUs, 2 nodes"
    assert len(shapes) == 10


def test_create_via_form_gives_spec_gpu(jwa):
    b = jwa.browser
    b.click("#new-btn")
    b.set_value('#new-form input[name="name"]', "from-ui")
    b.set_value('#new-form input[name="cpu"]', "1")
    b.set_value('#new-form input[name="memory"]', "2Gi")
    b.change("#gpu-acc", GPU)
    b.change("#gpu-topo", "1x1")
    assert b.submit("#new-form") is False  # preventDefault'd: JS owns it

    nb = jwa.kube_get("Notebook", "from-ui", "team")
    assert nb is not None
    assert nb["spec"]["gpu"] == {"accelerator": GPU, "topology": "1x1"}
    assert "tpu" not in nb["spec"]
    assert "Creating notebook from-ui" in b.document.text_content()

    jwa.poll_ui()
    table = table_text(jwa)
    assert "from-ui" in table and "Running" in table
    assert f"{GPU} 1x1" in table and "1/1 hosts" in table
    pod = jwa.kube_get("Pod", "from-ui-0", "team")
    assert pod["spec"]["containers"][0]["resources"]["limits"][
        "nvidia.com/gpu"] == "1"


def test_help_popover_names_the_torchrun_env(jwa):
    b = jwa.browser
    pop = b.query(".kf-popover")
    assert pop is not None and pop.style.props.get("display") == "none"
    b.click(".kf-help")
    assert pop.style.props.get("display") == "inline-block"
    assert "PET_*" in pop.text_content() and "GPU" in pop.text_content()
    b.keydown("Escape")
    assert pop.style.props.get("display") == "none"


def test_advanced_env_chips_and_the_gpu_toleration(jwa):
    b = jwa.browser
    b.click("#new-btn")
    b.click(b.query(".kf-advanced-toggle"))
    chip_input = b.query(".kf-chips-input input")
    chip_input._value = "NCCL_DEBUG=INFO"
    b.document.dispatch(chip_input, Event("keydown", {"key": "Enter"}))
    assert "NCCL_DEBUG=INFO" in b.text(".kf-chips")
    b.change("#toleration-group", "gpu-reserved")

    b.set_value('#new-form input[name="name"]', "envy")
    b.submit("#new-form")
    nb = jwa.kube_get("Notebook", "envy", "team")
    spec = nb["spec"]["template"]["spec"]
    env = {e["name"]: e.get("value") for e in spec["containers"][0]["env"]}
    assert env.get("NCCL_DEBUG") == "INFO"
    assert {"key": "nvidia.com/gpu", "operator": "Exists",
            "effect": "NoSchedule"} in spec["tolerations"]
    b.click(".kf-chip-x")
    assert "NCCL_DEBUG" not in b.text(".kf-chips")


def test_env_tab_groups_the_slice_and_torchrun_variables(jwa):
    b = jwa.browser
    jwa.kube_create("Notebook", nbapi.new("envtab", "team", accelerator=GPU,
                                          topology="1x8"))
    jwa.poll_ui()
    row = [el for el in b.query_all("#notebook-table tbody tr")
           if "envtab" in el.text_content()][0]
    b.click(row)
    assert "GPU slice" in b.text(".kf-drawer")
    env_tab = [t for t in b.query_all(".kf-tabs button")
               if t.text_content() == "Env"][0]
    b.click(env_tab)
    pane = b.text(".kf-tab-pane")
    assert "GPU slice" in pane and "TPU_WORKER_HOSTNAMES" in pane
    assert "torchrun / megascale" in pane and "PET_NODE_RANK" in pane
    assert "JAX / megascale" not in pane
    b.click(b.query(".kf-vars-group-head"))
    assert b.query(".kf-vars-group table").style.props.get(
        "display") == "none"


def test_multislice_spawn_from_form(jwa):
    """numSlices: hidden for CPU, shown for a GPU pick, flows into
    ``spec.gpu.numSlices``; the table badges the slice count and rolls up
    every node of both slices."""
    b = jwa.browser
    b.click("#new-btn")
    slices_input = b.query("#num-slices")
    assert slices_input.style.props.get("display") == "none"
    b.change("#gpu-acc", GPU)
    assert slices_input.style.props.get("display") == ""
    b.change("#gpu-topo", "2x8")
    slices_input._value = "2"
    b.set_value('#new-form input[name="name"]', "multi")
    b.submit("#new-form")

    nb = jwa.kube_get("Notebook", "multi", "team")
    assert nb["spec"]["gpu"] == {"accelerator": GPU, "topology": "2x8",
                                 "numSlices": 2}
    jwa.poll_ui(rounds=3)
    table = table_text(jwa)
    assert f"{GPU} 2x8 ×2" in table
    assert jwa.kube_get("StatefulSet", "multi-s0", "team") is not None
    assert jwa.kube_get("StatefulSet", "multi-s1", "team") is not None
    assert "4/4 hosts" in table
