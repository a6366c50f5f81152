/* JWA frontend: resource table + spawner form + details drawer.
 *
 * The reference's Angular jupyter app distilled onto the shared KF lib:
 * sortable resource table with status icons and polling, GPU
 * accelerator/shape pickers from /api/gpus, confirm dialogs, and a
 * details drawer with Overview / GPU slice / Conditions / Events / Logs /
 * YAML tabs wired to the backend's pod, events and logs routes.
 */

/* Static-chrome + form-label keys (the dynamic strings use the common
 * jwa.* / table.* / action.* catalogs in kubeflow.js). */
KF.registerMessages("en", {
  "jwa.title": "Notebook Servers",
  "jwa.namespace": "namespace",
  "jwa.fromYaml": "From YAML",
  "jwa.fromYamlTitle": "Create a Notebook from a raw manifest",
  "jwa.newNotebook": "+ New notebook",
  "jwa.formTitle": "New notebook server",
  "jwa.formName": "Name",
  "jwa.formServerType": "Server type",
  "jwa.formImage": "Image",
  "jwa.formCustomImage": "Custom image",
  "jwa.formTopology": "Topology",
  "jwa.formSlices": "Slices",
  "jwa.formCapacity": "Capacity",
  "jwa.queuedHint":
    "queue a ProvisioningRequest (start when capacity is reserved)",
  "jwa.formAdvanced": "Advanced",
  "jwa.formWorkspaceVolume": "Workspace volume",
  "jwa.formDataVolumes": "Data volumes",
  "jwa.formConfigurations": "Configurations",
  "jwa.noneAvailable": "none available",
  "jwa.formSharedMemory": "Shared memory",
  "jwa.shmMount": "mount",
  "jwa.launch": "Launch",
});
KF.registerMessages("de", {
  "jwa.title": "Notebook-Server",
  "jwa.namespace": "Namespace",
  "jwa.fromYaml": "Aus YAML",
  "jwa.fromYamlTitle": "Notebook aus einem Roh-Manifest erstellen",
  "jwa.newNotebook": "+ Neues Notebook",
  "jwa.formTitle": "Neuer Notebook-Server",
  "jwa.formName": "Name",
  "jwa.formServerType": "Server-Typ",
  "jwa.formImage": "Image",
  "jwa.formCustomImage": "Eigenes Image",
  "jwa.formTopology": "Topologie",
  "jwa.formSlices": "Slices",
  "jwa.formCapacity": "Kapazität",
  "jwa.queuedHint":
    "ProvisioningRequest einreihen (Start, sobald Kapazität reserviert ist)",
  "jwa.formAdvanced": "Erweitert",
  "jwa.formWorkspaceVolume": "Workspace-Volume",
  "jwa.formDataVolumes": "Daten-Volumes",
  "jwa.formConfigurations": "Konfigurationen",
  "jwa.noneAvailable": "keine verfügbar",
  "jwa.formSharedMemory": "Gemeinsamer Speicher",
  "jwa.shmMount": "einhängen:",
  "jwa.launch": "Starten",
});
KF.registerMessages("fr", {
  "jwa.title": "Serveurs de notebooks",
  "jwa.namespace": "namespace",
  "jwa.fromYaml": "Depuis YAML",
  "jwa.fromYamlTitle": "Créer un Notebook à partir d'un manifeste brut",
  "jwa.newNotebook": "+ Nouveau notebook",
  "jwa.formTitle": "Nouveau serveur de notebooks",
  "jwa.formName": "Nom",
  "jwa.formServerType": "Type de serveur",
  "jwa.formImage": "Image",
  "jwa.formCustomImage": "Image personnalisée",
  "jwa.formTopology": "Topologie",
  "jwa.formSlices": "Slices",
  "jwa.formCapacity": "Capacité",
  "jwa.queuedHint":
    "mettre en file une ProvisioningRequest (démarre quand la capacité " +
    "est réservée)",
  "jwa.formAdvanced": "Avancé",
  "jwa.formWorkspaceVolume": "Volume d'espace de travail",
  "jwa.formDataVolumes": "Volumes de données",
  "jwa.formConfigurations": "Configurations",
  "jwa.noneAvailable": "aucune disponible",
  "jwa.formSharedMemory": "Mémoire partagée",
  "jwa.shmMount": "monter",
  "jwa.launch": "Lancer",
});

let gpuCatalog = [];
let tablePoller = null;

/* Shared catalogs for the volume panels (KF.volumePanel): PVCs are
 * per-namespace; storage classes are cluster-scoped. The same object is
 * handed to every panel, so a namespace change refreshes them all. */
const volumeCatalogs = { pvcs: [], storageClasses: [], defaultClass: "" };
let workspacePanel = null;
let dataVolumesList = null;

function renderVolumeForms() {
  workspacePanel = KF.volumePanel({ kind: "workspace",
                                    catalogs: volumeCatalogs });
  document.getElementById("workspace-volume-slot")
    .replaceChildren(workspacePanel.root);
  dataVolumesList = KF.dataVolumesForm(
    document.getElementById("data-volumes-slot"), volumeCatalogs);
}

async function loadStorageCatalogs() {
  const [classes, dflt] = await Promise.all([
    api("api/storageclasses").catch(() => ({ storageClasses: [] })),
    api("api/storageclasses/default").catch(
      () => ({ defaultStorageClass: "" })),
  ]);
  volumeCatalogs.storageClasses = classes.storageClasses || [];
  volumeCatalogs.defaultClass = dflt.defaultStorageClass || "";
  renderVolumeForms();
}

async function loadNamespaceCatalogs() {
  /* PVCs for the volume panels + PodDefaults for configurations —
   * refetched on namespace change. */
  const [pvcs, pds] = await Promise.all([
    api(`api/namespaces/${ns.get()}/pvcs`).catch(() => ({ pvcs: [] })),
    api(`api/namespaces/${ns.get()}/poddefaults`).catch(() => ({
      poddefaults: [],
    })),
  ]);
  // The backend hands back raw PVC objects; the panels want name+size.
  volumeCatalogs.pvcs = (pvcs.pvcs || []).map((p) => ({
    name: ((p.metadata || {}).name) || p.name || "",
    capacity:
      ((((p.spec || {}).resources || {}).requests || {}).storage) ||
      p.capacity || "",
  })).filter((p) => p.name);
  renderVolumeForms();
  const slot = document.getElementById("configurations-slot");
  const options = pds.poddefaults || [];
  slot.classList.toggle("muted", !options.length);
  slot.replaceChildren(
    options.length
      ? options.map((pd) =>
          el(
            "label",
            { style: { display: "inline-flex", gap: "6px", marginRight: "14px" } },
            el("input", {
              type: "checkbox",
              name: "configuration",
              value: pd.label,
              style: { width: "auto" },
            }),
            pd.desc || pd.label
          )
        )
      : KF.t("jwa.noneAvailable")
  );
}

let spawnerConfig = {};

// Reference spawner_ui_config: image options per server type (jupyter-like
// NB_PREFIX images, vscode-like group-one, rstudio-like group-two).
const IMAGE_KEY_BY_TYPE = {
  jupyter: "image",
  "group-one": "imageGroupOne",
  "group-two": "imageGroupTwo",
};

function selectedServerType() {
  const checked = document.querySelector('input[name="serverType"]:checked');
  return checked ? checked.value : "jupyter";
}

function renderImageOptions() {
  const key = IMAGE_KEY_BY_TYPE[selectedServerType()];
  const images = (spawnerConfig[key] && spawnerConfig[key].options) || [];
  document
    .getElementById("image-select")
    .replaceChildren(...images.map((img) => el("option", { value: img }, img)));
}

async function loadCatalogs() {
  const [gpus, config] = await Promise.all([api("api/gpus"), api("api/config")]);
  gpuCatalog = gpus.gpus;
  spawnerConfig = config.config;

  document.getElementById("gpu-help-slot").replaceChildren(
    KF.helpPopover(
      "Accelerator + shape pick a GPU slice (<nodes>x<GPUs per node>): " +
        "multi-node shapes spawn one worker pod per node with PET_* wired " +
        "for torchrun."
    )
  );

  const accSelect = document.getElementById("gpu-acc");
  // NB: replaceChildren stringifies arrays — always spread node lists.
  accSelect.replaceChildren(
    el("option", { value: "" }, "none (CPU)"),
    ...gpuCatalog.map((t) => el("option", { value: t.accelerator }, t.accelerator))
  );
  accSelect.addEventListener("change", renderTopologies);
  renderTopologies();

  for (const radio of document.querySelectorAll('input[name="serverType"]')) {
    radio.addEventListener("change", renderImageOptions);
  }
  renderImageOptions();
}

function renderTopologies() {
  const acc = document.getElementById("gpu-acc").value;
  const topoSelect = document.getElementById("gpu-topo");
  const entry = gpuCatalog.find((t) => t.accelerator === acc);
  topoSelect.replaceChildren(
    ...(entry ? entry.topologies : []).map((t) =>
      el(
        "option",
        { value: t.topology },
        `${t.topology} — ${t.chips} GPU${t.chips > 1 ? "s" : ""}, ` +
          `${t.hosts} node${t.hosts > 1 ? "s" : ""}`
      )
    )
  );
  renderNumSlices();
}

function renderNumSlices() {
  /* Multislice (DCN-joined slices) and queued provisioning only make
   * sense with a GPU selected: show those controls then, hide (and
   * reset) them for CPU. */
  const acc = document.getElementById("gpu-acc").value;
  const input = document.getElementById("num-slices");
  const label = document.getElementById("num-slices-label");
  const show = acc ? "" : "none";
  input.style.display = show;
  label.style.display = show;
  if (!acc) input.value = "1";
  document.getElementById("queued-label").style.display = show;
  document.getElementById("queued-row").style.display =
    acc ? "inline-flex" : "none";
  if (!acc) document.getElementById("queued-prov").checked = false;
}

/* ---------------- details drawer ---------------------------------------- */

let openDrawerFor = null;

function openDetails(nb) {
  const name = nb.name;
  if (openDrawerFor === name) return;
  openDrawerFor = name;
  // Deep-linkable (the reference's per-resource details route).
  if (location.hash !== `#/notebook/${name}`) {
    history.replaceState(null, "", `#/notebook/${name}`);
  }
  const drawer = KF.drawer(`Notebook ${name}`);
  const tabHost = el("div", {});
  drawer.content.append(tabHost);

  const podsFor = () =>
    api(`api/namespaces/${ns.get()}/notebooks/${name}/pod`).then((body) =>
      body.pods.map((p) => ({
        name: p.metadata.name,
        ready: (p.status && p.status.phase) === "Running",
      }))
    );

  const tabs = KF.tabs(tabHost, [
    {
      label: "Overview",
      render: (pane) => {
        const status = el("div", {});
        const slice = el("div", {});
        pane.append(
          el("h4", {}, "Status"),
          status,
          el("h4", {}, "GPU slice"),
          slice
        );
        async function load() {
          const body = await api(
            `api/namespaces/${ns.get()}/notebooks/${name}`
          );
          const meta = body.notebook.metadata || {};
          const ps = body.processedStatus || {};
          status.replaceChildren(
            KF.detailsList([
              ["Status", KF.statusDot(ps.phase, ps.message)],
              ["Message", ps.message],
              ["Image", nb.image],
              ["CPU / Memory", `${nb.cpu || "—"} / ${nb.memory || "—"}`],
              ["Created", KF.ageCell(meta.creationTimestamp, " ago")],
              [
                "Connect",
                el(
                  "a",
                  { href: KF.urls.notebook(ns.get(), name), target: "_blank" },
                  KF.urls.notebook(ns.get(), name)
                ),
              ],
            ])
          );
          const pods = await podsFor().catch(() => []);
          const nbAnns =
            (body.notebook.metadata && body.notebook.metadata.annotations) ||
            {};
          KF.sliceRollup(
            slice,
            body.notebook.spec && body.notebook.spec.gpu,
            body.notebook.status && body.notebook.status.gpu,
            pods,
            {
              maintenancePending:
                nbAnns["notebooks.kubeflow.org/maintenance-pending"],
            }
          );
        }
        load().catch(KF.showError);
        const t = setInterval(() => load().catch(() => {}), 5000);
        return { stop: () => clearInterval(t) };
      },
    },
    {
      label: "Conditions",
      render: (pane) => {
        const host = el("div", {});
        pane.append(host);
        api(`api/namespaces/${ns.get()}/notebooks/${name}`)
          .then((body) =>
            KF.conditionsTable(
              host,
              (body.notebook.status && body.notebook.status.conditions) || []
            )
          )
          .catch(KF.showError);
      },
    },
    {
      label: "Events",
      render: (pane) => {
        const host = el("div", {});
        pane.append(host);
        async function load() {
          const body = await api(
            `api/namespaces/${ns.get()}/notebooks/${name}/events`
          );
          KF.eventsTable(host, body.events);
        }
        load().catch(KF.showError);
        const t = setInterval(() => load().catch(() => {}), 5000);
        return { stop: () => clearInterval(t) };
      },
    },
    {
      label: "Env",
      render: (pane) => {
        /* Worker-0 environment grouped by source — the slice identity
         * (TPU_*) and torchrun's PET_* wiring is the first thing to check
         * when a slice won't bootstrap. */
        const host = el("div", {});
        pane.append(host);
        KF.withSpinner(
          host,
          api(`api/namespaces/${ns.get()}/notebooks/${name}/pod`),
          (slot, body) => {
            const containers =
              ((body.pods[0] || {}).spec || {}).containers || [];
            const env = ((containers[0] || {}).env || []).map((e) => ({
              key: e.name,
              value:
                e.value !== undefined
                  ? e.value
                  : e.valueFrom
                    ? "(downward API)"
                    : "",
            }));
            const groups = [
              {
                name: "GPU slice",
                vars: env.filter((v) => v.key.startsWith("TPU_")),
              },
              {
                name: "torchrun / megascale",
                vars: env.filter(
                  (v) =>
                    v.key.startsWith("PET_") || v.key.startsWith("MEGASCALE_")
                ),
              },
              {
                name: "Other",
                vars: env.filter(
                  (v) =>
                    !v.key.startsWith("TPU_") &&
                    !v.key.startsWith("PET_") &&
                    !v.key.startsWith("MEGASCALE_")
                ),
              },
            ].filter((group) => group.vars.length);
            KF.varsGroupsTable(slot, groups);
          }
        ).catch(() => {});
      },
    },
    {
      label: "Logs",
      render: (pane) => {
        const host = el("div", {});
        pane.append(host);
        let viewer = null;
        podsFor()
          .then((pods) => {
            viewer = KF.logsViewer(host, pods, (pod) =>
              api(
                `api/namespaces/${ns.get()}/notebooks/${name}/pod/${pod}/logs`
              ).then((body) => body.logs)
            );
          })
          .catch((err) => {
            host.replaceChildren(
              el("p", { class: "muted" }, "No pods yet: " + err.message)
            );
          });
        return { stop: () => viewer && viewer.stop() };
      },
    },
    {
      label: "YAML",
      render: (pane) => {
        const host = el("div", {});
        pane.append(host);
        api(`api/namespaces/${ns.get()}/notebooks/${name}`)
          .then((body) => KF.yamlView(host, body.notebook))
          .catch(KF.showError);
      },
    },
  ]);
  drawer.onclose = () => {
    tabs.stop();
    openDrawerFor = null;
    if (location.hash.startsWith("#/notebook/")) {
      history.replaceState(null, "", location.pathname);
    }
  };
}

function openDetailsFromHash() {
  const match = location.hash.match(/^#\/notebook\/([a-z0-9-]+)$/);
  if (!match) return;
  api(`api/namespaces/${ns.get()}/notebooks/${match[1]}`)
    .then((body) => {
      const nb = body.notebook;
      const containers =
        (((nb.spec || {}).template || {}).spec || {}).containers || [{}];
      openDetails({
        name: match[1],
        image: containers[0].image || "",
        cpu: null,
        memory: null,
      });
    })
    .catch(() => {});
}

/* ---------------- list table -------------------------------------------- */

async function refresh() {
  const body = await api(`api/namespaces/${ns.get()}/notebooks`);
  const columns = [
    {
      title: () => KF.t("table.status"),
      render: (nb) => statusDot(nb.status.phase, nb.status.message),
      sortKey: (nb) => nb.status.phase,
    },
    { title: () => KF.t("table.name"), render: (nb) => nb.name, sortKey: (nb) => nb.name },
    {
      title: () => KF.t("table.image"),
      render: (nb) => nb.image.split("/").pop(),
      sortKey: (nb) => nb.image,
    },
    { title: () => KF.t("table.cpu"), render: (nb) => nb.cpu || "—" },
    { title: () => KF.t("table.memory"), render: (nb) => nb.memory || "—" },
    {
      title: () => KF.t("table.gpu"),
      render: (nb) =>
        nb.gpu
          ? el(
              "span",
              {},
              el(
                "span",
                { class: "chip" },
                `${nb.gpu.accelerator} ${nb.gpu.topology}` +
                  (nb.gpu.numSlices > 1 ? ` ×${nb.gpu.numSlices}` : "")
              ),
              nb.gpuStatus
                ? `${nb.gpuStatus.readyHosts}/${nb.gpuStatus.hosts} hosts`
                : ""
            )
          : "—",
      sortKey: (nb) => (nb.gpu ? nb.gpu.accelerator : ""),
    },
    {
      title: () => KF.t("table.age"),
      render: (nb) => KF.ageCell(nb.age),
      sortKey: (nb) => nb.age || "",
    },
    {
      title: () => KF.t("table.lastActivity"),
      render: (nb) => (nb.lastActivity ? KF.ageCell(nb.lastActivity, " ago") : "—"),
      sortKey: (nb) => nb.lastActivity || "",
    },
    {
      title: () => KF.t("table.actions"),
      render: (nb) => {
        const stopped = nb.status.phase === "stopped";
        return el(
          "span",
          {},
          KF.actionButton(stopped ? KF.t("action.start") : KF.t("action.stop"), () =>
            api(`api/namespaces/${ns.get()}/notebooks/${nb.name}`, {
              method: "PATCH",
              body: JSON.stringify({ stopped: !stopped }),
            }).then(() => {
              KF.snackbar(
                (stopped ? "Starting " : "Stopping ") + nb.name
              );
              tablePoller.refresh();
            }, showError)
          ),
          " ",
          KF.actionButton(
            KF.t("action.delete"),
            () =>
              KF.confirmDialog({
                title: `Delete notebook ${nb.name}?`,
                message:
                  "The notebook's pods are deleted; workspace volumes are kept.",
              }).then(
                (ok) =>
                  ok &&
                  api(`api/namespaces/${ns.get()}/notebooks/${nb.name}`, {
                    method: "DELETE",
                  }).then(() => {
                    KF.snackbar("Deleting " + nb.name);
                    tablePoller.refresh();
                  }, showError)
              ),
            { class: "danger" }
          ),
          " ",
          el(
            "a",
            {
              href: KF.urls.notebook(ns.get(), nb.name),
              target: "_blank",
              onclick: (ev) => ev.stopPropagation(),
            },
            KF.t("action.connect")
          )
        );
      },
    },
  ];
  renderTable(document.getElementById("notebook-table"), columns, body.notebooks, {
    onRowClick: openDetails,
    emptyText: KF.t("jwa.empty"),
    pageSize: 25,
    filterable: true,
  });
}

/* ---------------- spawner form ------------------------------------------ */

const nameInput = document.querySelector('#new-form input[name="name"]');
const cpuInput = document.querySelector('#new-form input[name="cpu"]');
const memInput = document.querySelector('#new-form input[name="memory"]');
const checks = [
  KF.validate(nameInput, KF.validators.dns1123),
  KF.validate(cpuInput, KF.validators.positiveNumber),
  KF.validate(memInput, KF.validators.memoryQuantity),
];

/* Advanced options: collapsed by default; extra environment variables as
 * a KEY=VALUE chips input (feeds the backend's `environment` form field),
 * plus the admin-defined toleration preset when the config offers one. */
let extraEnv = [];
document.getElementById("advanced-slot").append(
  KF.advancedSection("Advanced options", (pane) => {
    // Admin presets share one builder: label + select with a "none"
    // option, keyed by the config's option-key field. Call sites pass
    // the id as a literal attrs object so static DOM-contract checks
    // can see which ids the JS creates.
    const presetSelect = (attrs, label, options, keyField) =>
      options.length
        ? [
            el(
              "label",
              { style: { display: "block", margin: "10px 0 4px" } },
              label
            ),
            el(
              "select",
              Object.assign({ style: { width: "auto" } }, attrs),
              el("option", { value: "" }, "none"),
              ...options.map((opt) =>
                el(
                  "option",
                  { value: opt[keyField] },
                  opt.displayName || opt[keyField]
                )
              )
            ),
          ]
        : [];
    pane.append(
      el("label", { style: { display: "block", marginBottom: "4px" } },
        "Environment variables (KEY=VALUE)"),
      KF.chipsInput(extraEnv, (values) => {
        extraEnv = values;
      }, {
        placeholder: "e.g. NCCL_DEBUG=INFO",
        validate: (value) =>
          /^[A-Za-z_][A-Za-z0-9_]*=.*$/.test(value)
            ? null
            : "Use KEY=VALUE (key: letters, digits, underscores).",
      }),
      ...presetSelect(
        { id: "toleration-group" }, "Toleration preset",
        (spawnerConfig.tolerationGroup &&
          spawnerConfig.tolerationGroup.options) || [],
        "groupKey"
      ),
      ...presetSelect(
        { id: "affinity-config" }, "Affinity preset",
        (spawnerConfig.affinityConfig &&
          spawnerConfig.affinityConfig.options) || [],
        "configKey"
      )
    );
  })
);

document.getElementById("new-btn").addEventListener("click", () => {
  document.getElementById("new-form-card").style.display = "block";
});
document.getElementById("yaml-btn").addEventListener("click", () => {
  const template = [
    "apiVersion: kubeflow.org/v1",
    "kind: Notebook",
    "metadata:",
    "  name: my-notebook",
    "spec:",
    "  gpu:",
    "    accelerator: nvidia-h100-80gb",
    '    topology: "1x1"',
    "  template:",
    "    spec:",
    "      containers:",
    "        - name: my-notebook",
    "          image: kubeflow-tpu/jupyter-jax:latest",
    "",
  ].join("\n");
  KF.yamlEditDialog({
    title: "Create Notebook from YAML",
    initial: template,
    submitText: "Create",
    onSubmit: (text) =>
      api(`api/namespaces/${ns.get()}/notebooks/yaml`, {
        method: "POST",
        headers: { "Content-Type": "application/yaml" },
        body: text,
      }),
  }).then((created) => {
    if (created) {
      KF.snackbar("Notebook created");
      tablePoller.refresh();
    }
  });
});
document.getElementById("cancel-btn").addEventListener("click", () => {
  document.getElementById("new-form-card").style.display = "none";
});
document.getElementById("new-form").addEventListener("submit", (ev) => {
  ev.preventDefault();
  if (!checks.every((check) => check())) {
    KF.snackbar("Fix the highlighted fields first.", "error");
    return;
  }
  const form = new FormData(ev.target);
  const payload = {
    name: form.get("name"),
    serverType: form.get("serverType") || "jupyter",
    cpu: form.get("cpu"),
    memory: form.get("memory"),
  };
  if (form.get("customImage")) payload.customImage = form.get("customImage");
  else payload.image = form.get("image");
  if (form.get("gpu-acc")) {
    payload.gpu = {
      accelerator: form.get("gpu-acc"),
      topology: form.get("gpu-topo"),
    };
    const slices = parseInt(form.get("numSlices"), 10);
    if (slices > 1) payload.gpu.numSlices = slices;
    if (document.getElementById("queued-prov").checked) {
      payload.gpu.queuedProvisioning = true;
    }
  }
  /* Volumes: the panels own the whole story (new-vs-existing, size,
   * class, access mode, mount). A "none" workspace explicitly suppresses
   * the config default; data volumes are included only when present. */
  payload.workspaceVolume = workspacePanel ? workspacePanel.value() : null;
  const dataVols = dataVolumesList ? dataVolumesList.value() : [];
  if (dataVols.length) payload.dataVolumes = dataVols;
  payload.shm = !!form.get("shm");
  const configurations = [
    ...ev.target.querySelectorAll('input[name="configuration"]:checked'),
  ].map((box) => box.value);
  if (configurations.length) payload.configurations = configurations;
  if (extraEnv.length) {
    payload.environment = {};
    for (const entry of extraEnv) {
      const eq = entry.indexOf("=");
      if (eq > 0) payload.environment[entry.slice(0, eq)] = entry.slice(eq + 1);
    }
  }
  const tolerationSelect = document.getElementById("toleration-group");
  if (tolerationSelect && tolerationSelect.value) {
    payload.tolerationGroup = tolerationSelect.value;
  }
  const affinitySelect = document.getElementById("affinity-config");
  if (affinitySelect && affinitySelect.value) {
    payload.affinityConfig = affinitySelect.value;
  }
  api(`api/namespaces/${ns.get()}/notebooks`, {
    method: "POST",
    body: JSON.stringify(payload),
  }).then(() => {
    document.getElementById("new-form-card").style.display = "none";
    KF.snackbar("Creating notebook " + payload.name);
    tablePoller.refresh();
  }, showError);
});

document.getElementById("ns-slot").append(
  namespacePicker(() => {
    tablePoller.refresh();
    loadNamespaceCatalogs().catch(() => {});
  }),
  " ",
  KF.localePicker()
);
/* Locale switch re-renders the live table (headers, status labels,
 * action buttons) AND the already-built volume panels (mode selects,
 * field labels) in place — refresh() alone left the form in the old
 * locale until a namespace change happened to rebuild it. */
KF.localizeDocument();
KF.onLocaleChange(() => {
  renderVolumeForms();
  refresh().catch(() => {});
});
loadCatalogs().catch(showError);
loadStorageCatalogs().catch(() => {});
loadNamespaceCatalogs().catch(() => {});
tablePoller = poll(refresh);
openDetailsFromHash();
window.addEventListener("hashchange", openDetailsFromHash);
