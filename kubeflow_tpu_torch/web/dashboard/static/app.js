/* Dashboard frontend: workgroup bootstrap, app links, namespaces, GPU
 * usage, and time-series metrics panels (sparklines over /api/metrics —
 * the reference's resource-chart.js over the pluggable metrics service).
 * All user-visible strings route through KF.t (reference: the
 * centraldashboard's i18n pipeline). */

KF.registerMessages("en", {
  "cd.metricGpuDuty": "GPU duty cycle",
  "cd.metricNodeCpu": "Node CPU",
  "cd.metricPodMem": "Pod memory",
  "cd.noQuota": "no quota",
  "cd.quota": "quota {n}",
  "cd.chipsRequested": "{n} GPUs requested in {ns} ({quota})",
  "cd.noGpuPods": "No GPU pods running.",
  "cd.noRecentEvents": "No recent events in {ns}.",
  "cd.loading": "loading…",
  "cd.noDataInRange": "no data in range",
  "cd.noMetricsBackend": "no metrics backend configured (set PROMETHEUS_URL)",
  "cd.latest": "latest: {value} ({label})",
  "cd.metricsUnavailable": "metrics unavailable: {message}",
  "cd.contributorsTitle": "Contributors — {ns}",
  "cd.loadingCap": "Loading…",
  "cd.remove": "Remove",
  "cd.noContributors": "No contributors yet.",
  "cd.contributorsHint":
    "Contributors get edit access to every app in this namespace.",
  "cd.contributorAdded": "Contributor added",
  "cd.add": "Add",
  "cd.colNamespace": "Namespace",
  "cd.colRole": "Role",
  "cd.colContributors": "Contributors",
  "cd.manage": "Manage",
  "cd.emptyNamespaces": "No namespaces yet — register a workgroup below.",
  "cd.workgroupCreated": "Workgroup created",
  "cd.title": "Kubeflow TPU",
  "cd.welcome": "Welcome",
  "cd.noWorkspaceYet": "You don't have a workspace namespace yet.",
  "cd.createMyNamespace": "Create my namespace",
  "cd.applications": "Applications",
  "cd.myNamespaces": "My namespaces",
  "cd.gpuUsage": "GPU usage",
  "cd.recentActivity": "Recent activity",
  "cd.clusterMetrics": "Cluster metrics",
  "cd.selectNamespace": "Select a namespace above.",
  "cd.ago": " ago",
});
KF.registerMessages("de", {
  "cd.metricGpuDuty": "GPU-Auslastung",
  "cd.metricNodeCpu": "Node-CPU",
  "cd.metricPodMem": "Pod-Speicher",
  "cd.noQuota": "kein Kontingent",
  "cd.quota": "Kontingent {n}",
  "cd.chipsRequested": "{n} GPUs angefordert in {ns} ({quota})",
  "cd.noGpuPods": "Keine GPU-Pods laufen.",
  "cd.noRecentEvents": "Keine aktuellen Ereignisse in {ns}.",
  "cd.loading": "lädt…",
  "cd.noDataInRange": "keine Daten im Zeitraum",
  "cd.noMetricsBackend":
    "kein Metrik-Backend konfiguriert (PROMETHEUS_URL setzen)",
  "cd.latest": "aktuell: {value} ({label})",
  "cd.metricsUnavailable": "Metriken nicht verfügbar: {message}",
  "cd.contributorsTitle": "Mitwirkende — {ns}",
  "cd.loadingCap": "Lädt…",
  "cd.remove": "Entfernen",
  "cd.noContributors": "Noch keine Mitwirkenden.",
  "cd.contributorsHint":
    "Mitwirkende erhalten Schreibzugriff auf alle Apps in diesem Namespace.",
  "cd.contributorAdded": "Mitwirkende(r) hinzugefügt",
  "cd.add": "Hinzufügen",
  "cd.colNamespace": "Namespace",
  "cd.colRole": "Rolle",
  "cd.colContributors": "Mitwirkende",
  "cd.manage": "Verwalten",
  "cd.emptyNamespaces":
    "Noch keine Namespaces — unten eine Workgroup registrieren.",
  "cd.workgroupCreated": "Workgroup erstellt",
  "cd.title": "Kubeflow TPU",
  "cd.welcome": "Willkommen",
  "cd.noWorkspaceYet": "Sie haben noch keinen Workspace-Namespace.",
  "cd.createMyNamespace": "Meinen Namespace erstellen",
  "cd.applications": "Anwendungen",
  "cd.myNamespaces": "Meine Namespaces",
  "cd.gpuUsage": "GPU-Nutzung",
  "cd.recentActivity": "Aktuelle Aktivität",
  "cd.clusterMetrics": "Cluster-Metriken",
  "cd.selectNamespace": "Oben einen Namespace auswählen.",
  "cd.ago": " zuvor",
});
KF.registerMessages("fr", {
  "cd.metricGpuDuty": "Taux d'occupation GPU",
  "cd.metricNodeCpu": "CPU du nœud",
  "cd.metricPodMem": "Mémoire des pods",
  "cd.noQuota": "pas de quota",
  "cd.quota": "quota {n}",
  "cd.chipsRequested": "{n} GPU demandés dans {ns} ({quota})",
  "cd.noGpuPods": "Aucun pod GPU en cours.",
  "cd.noRecentEvents": "Aucun événement récent dans {ns}.",
  "cd.loading": "chargement…",
  "cd.noDataInRange": "aucune donnée sur la période",
  "cd.noMetricsBackend":
    "aucun backend de métriques configuré (définir PROMETHEUS_URL)",
  "cd.latest": "dernier : {value} ({label})",
  "cd.metricsUnavailable": "métriques indisponibles : {message}",
  "cd.contributorsTitle": "Contributeurs — {ns}",
  "cd.loadingCap": "Chargement…",
  "cd.remove": "Retirer",
  "cd.noContributors": "Aucun contributeur pour l'instant.",
  "cd.contributorsHint":
    "Les contributeurs ont un accès en écriture à toutes les " +
    "applications de ce namespace.",
  "cd.contributorAdded": "Contributeur ajouté",
  "cd.add": "Ajouter",
  "cd.colNamespace": "Namespace",
  "cd.colRole": "Rôle",
  "cd.colContributors": "Contributeurs",
  "cd.manage": "Gérer",
  "cd.emptyNamespaces":
    "Aucun namespace — enregistrez un groupe de travail ci-dessous.",
  "cd.workgroupCreated": "Groupe de travail créé",
  "cd.title": "Kubeflow TPU",
  "cd.welcome": "Bienvenue",
  "cd.noWorkspaceYet":
    "Vous n'avez pas encore de namespace d'espace de travail.",
  "cd.createMyNamespace": "Créer mon namespace",
  "cd.applications": "Applications",
  "cd.myNamespaces": "Mes namespaces",
  "cd.gpuUsage": "Utilisation GPU",
  "cd.recentActivity": "Activité récente",
  "cd.clusterMetrics": "Métriques du cluster",
  "cd.selectNamespace": "Sélectionnez un namespace ci-dessus.",
  "cd.ago": " plus tôt",
});

const METRIC_PANELS = [
  { type: "gpu_duty", labelKey: "cd.metricGpuDuty" },
  { type: "node_cpu", labelKey: "cd.metricNodeCpu" },
  { type: "pod_mem", labelKey: "cd.metricPodMem" },
];

async function loadLinks() {
  const body = await api("api/dashboard-links");
  document
    .getElementById("links")
    .replaceChildren(
      ...body.menuLinks.map((link) =>
        el("a", { href: link.link, style: "margin-right:24px" }, link.text)
      )
    );
}

async function loadGpuUsage(namespace) {
  const body = await api(`api/namespaces/${namespace}/gpu-usage`);
  const target = document.getElementById("gpu-table");
  const quota = body.chipsQuota == null
    ? KF.t("cd.noQuota")
    : KF.t("cd.quota", { n: body.chipsQuota });
  target.classList.remove("muted");
  target.replaceChildren(
    el("p", {}, KF.t("cd.chipsRequested",
                     { n: body.chipsRequested, ns: namespace, quota })),
    body.pods.length
      ? el(
          "div",
          {},
          body.pods.map((p) =>
            el("span", { class: "chip" }, `${p.pod}: ${p.chips}`)
          )
        )
      : el("p", { class: "muted" }, KF.t("cd.noGpuPods"))
  );
}

async function loadActivities(namespace) {
  /* Reference /api/activities/:namespace — the landing page's "recent
   * activity" feed of namespace events, newest first. */
  const body = await api(`api/activities/${namespace}`);
  const target = document.getElementById("activities");
  target.classList.remove("muted");
  target.replaceChildren(
    body.activities.length
      ? el(
          "ul",
          { class: "activity-feed" },
          body.activities.slice(0, 15).map((a) =>
            el(
              "li",
              { class: a.type === "Warning" ? "event-warning" : "" },
              KF.ageCell(a.time, KF.t("cd.ago")),
              el("span", { class: "muted" }, " — "),
              `${a.involved.kind} ${a.involved.name}: ${a.reason} `,
              el("span", { class: "muted" }, a.message)
            )
          )
        )
      : el("p", { class: "muted" },
           KF.t("cd.noRecentEvents", { ns: namespace }))
  );
}

async function loadMetrics() {
  const host = document.getElementById("metrics-panels");
  if (!host) return;
  for (const panel of METRIC_PANELS) {
    let slot = document.getElementById("metric-" + panel.type);
    if (!slot) {
      slot = el(
        "div",
        { id: "metric-" + panel.type, class: "card" },
        el("h4", { class: "metric-title" }, KF.t(panel.labelKey)),
        el("canvas", { class: "spark" }),
        el("p", { class: "muted metric-note" }, KF.t("cd.loading"))
      );
      host.append(slot);
    } else {
      slot.querySelector(".metric-title").textContent = KF.t(panel.labelKey);
    }
    try {
      const body = await api(
        `api/metrics?type=${panel.type}&interval=Last15m`
      );
      KF.sparkline(slot.querySelector("canvas"), body.points);
      const note = slot.querySelector(".metric-note");
      if (!body.points.length) {
        note.textContent = body.resourceChartsLink
          ? KF.t("cd.noDataInRange")
          : KF.t("cd.noMetricsBackend");
      } else {
        const last = body.points[body.points.length - 1];
        note.textContent = KF.t("cd.latest", {
          value: last.value.toFixed(3),
          label: last.label || panel.type,
        });
      }
    } catch (err) {
      slot.querySelector(".metric-note").textContent =
        KF.t("cd.metricsUnavailable", { message: err.message });
    }
  }
}

function openContributors(n) {
  /* Manage-contributors drawer (the reference dashboard's manage-users
   * view over KFAM bindings). Only owners can mutate; others see a 403
   * surfaced in the list area. */
  const drawer = KF.drawer(KF.t("cd.contributorsTitle", { ns: n.namespace }));
  const list = el("div", {}, KF.t("cd.loadingCap"));
  const emailInput = el("input", {
    placeholder: "someone@example.com",
    style: { width: "260px" },
  });
  async function load() {
    try {
      const body = await api(
        `api/workgroup/get-contributors/${n.namespace}`
      );
      list.replaceChildren(
        body.contributors.length
          ? el(
              "ul",
              {},
              body.contributors.map((email) =>
                el(
                  "li",
                  { style: { marginBottom: "6px" } },
                  email + " ",
                  KF.actionButton(KF.t("cd.remove"), () =>
                    api(
                      `api/workgroup/remove-contributor/${n.namespace}`,
                      {
                        method: "DELETE",
                        body: JSON.stringify({ contributor: email }),
                      }
                    ).then(load, KF.showError)
                  , { class: "danger" })
                )
              )
            )
          : el("p", { class: "muted" }, KF.t("cd.noContributors"))
      );
    } catch (err) {
      list.replaceChildren(el("p", { class: "muted" }, err.message));
    }
  }
  drawer.content.append(
    el("p", { class: "muted" }, KF.t("cd.contributorsHint")),
    list,
    el(
      "div",
      { style: { display: "flex", gap: "8px", marginTop: "12px" } },
      emailInput,
      el(
        "button",
        {
          class: "primary",
          onclick: () =>
            api(`api/workgroup/add-contributor/${n.namespace}`, {
              method: "POST",
              body: JSON.stringify({ contributor: emailInput.value }),
            }).then(() => {
              emailInput.value = "";
              KF.snackbar(KF.t("cd.contributorAdded"));
              load();
            }, KF.showError),
        },
        KF.t("cd.add")
      )
    )
  );
  load();
}

async function refresh() {
  const info = await api("api/workgroup/env-info");
  document.getElementById("user-slot").textContent = info.user;
  const exists = await api("api/workgroup/exists");
  document.getElementById("register-card").style.display =
    exists.hasWorkgroup || !exists.registrationFlowAllowed ? "none" : "block";
  renderTable(
    document.getElementById("ns-table"),
    [
      {
        title: () => KF.t("cd.colNamespace"),
        render: (n) =>
          el(
            "a",
            {
              href: "#",
              onclick: (ev) => {
                ev.preventDefault();
                KF.ns.set(n.namespace);
                loadGpuUsage(n.namespace).catch(showError);
                loadActivities(n.namespace).catch(showError);
              },
            },
            n.namespace
          ),
        sortKey: (n) => n.namespace,
      },
      { title: () => KF.t("cd.colRole"), render: (n) => n.role },
      {
        title: () => KF.t("cd.colContributors"),
        render: (n) =>
          n.role === "owner"
            ? KF.actionButton(KF.t("cd.manage"), () => openContributors(n))
            : "—",
      },
    ],
    info.namespaces,
    { emptyText: KF.t("cd.emptyNamespaces"), pageSize: 25, filterable: true }
  );
  if (info.namespaces.length) {
    loadGpuUsage(info.namespaces[0].namespace).catch(() => {});
    loadActivities(info.namespaces[0].namespace).catch(() => {});
  }
  await loadMetrics();
}

document.getElementById("register-btn").addEventListener("click", () => {
  api("api/workgroup/create", { method: "POST", body: "{}" }).then(
    () => {
      KF.snackbar(KF.t("cd.workgroupCreated"));
      refresh().catch(showError);
    },
    showError
  );
});

const localeSlot = document.getElementById("locale-slot");
if (localeSlot) localeSlot.append(KF.localePicker());
KF.localizeDocument();
KF.onLocaleChange(() => refresh().catch(() => {}));
loadLinks().catch(showError);
poll(refresh, 10000);
