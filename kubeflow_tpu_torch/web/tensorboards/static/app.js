/* TWA frontend on the shared KF lib: sortable table, confirm dialogs,
 * snackbars, details drawer with the logspath scheme explained. All
 * user-visible strings route through KF.t (reference: the tensorboards
 * frontend's xlf translation pipeline). */

KF.registerMessages("en", {
  "twa.drawerTitle": "TensorBoard {name}",
  "twa.logsPath": "Logs path",
  "twa.source": "Source",
  "twa.open": "Open",
  "twa.schemeUnknown": "unknown",
  "twa.schemePvc": "PVC subpath",
  "twa.schemeGcs": "GCS bucket (torch.profiler traces)",
  "twa.schemeS3": "S3 bucket",
  "twa.schemePath": "path",
  "twa.profilerHintPre": "gs:// paths serve profiler traces (*.pt.trace.json) captured with ",
  "twa.profilerHintPost": " — open the Profile tab inside TensorBoard; its capture button records a live *.xplane.pb from a notebook that ran sdk.start_profiler_server().",
  "twa.events": "Events",
  "twa.noEvents": "No events.",
  "twa.deleteTitle": "Delete TensorBoard {name}?",
  "twa.deleteMessage": "The server is removed; the logs themselves are kept.",
  "twa.deleting": "Deleting {name}",
  "twa.empty": "No TensorBoards in this namespace.",
  "twa.fixName": "Fix the name first.",
  "twa.creating": "Creating TensorBoard {name}",
  "twa.title": "TensorBoards",
  "twa.namespace": "namespace",
  "twa.newTensorboard": "+ New TensorBoard",
  "twa.formTitle": "New TensorBoard",
  "twa.formName": "Name",
  "twa.formLogspath": "Logs path",
  "twa.formProfiler": "PyTorch profiler",
  "twa.create": "Create",
});
KF.registerMessages("de", {
  "twa.drawerTitle": "TensorBoard {name}",
  "twa.logsPath": "Log-Pfad",
  "twa.source": "Quelle",
  "twa.open": "Öffnen",
  "twa.schemeUnknown": "unbekannt",
  "twa.schemePvc": "PVC-Unterpfad",
  "twa.schemeGcs": "GCS-Bucket (torch.profiler-Traces)",
  "twa.schemeS3": "S3-Bucket",
  "twa.schemePath": "Pfad",
  "twa.profilerHintPre": "gs://-Pfade liefern Profiler-Traces (*.pt.trace.json), aufgezeichnet mit ",
  "twa.profilerHintPost": " — den Profile-Tab in TensorBoard öffnen; seine Capture-Schaltfläche zeichnet live ein *.xplane.pb eines Notebooks auf, das sdk.start_profiler_server() ausgeführt hat.",
  "twa.events": "Ereignisse",
  "twa.noEvents": "Keine Ereignisse.",
  "twa.deleteTitle": "TensorBoard {name} löschen?",
  "twa.deleteMessage": "Der Server wird entfernt; die Logs selbst bleiben erhalten.",
  "twa.deleting": "{name} wird gelöscht",
  "twa.empty": "Keine TensorBoards in diesem Namespace.",
  "twa.fixName": "Bitte zuerst den Namen korrigieren.",
  "twa.creating": "TensorBoard {name} wird erstellt",
  "twa.title": "TensorBoards",
  "twa.namespace": "Namespace",
  "twa.newTensorboard": "+ Neues TensorBoard",
  "twa.formTitle": "Neues TensorBoard",
  "twa.formName": "Name",
  "twa.formLogspath": "Log-Pfad",
  "twa.formProfiler": "PyTorch-Profiler",
  "twa.create": "Erstellen",
});
KF.registerMessages("fr", {
  "twa.drawerTitle": "TensorBoard {name}",
  "twa.logsPath": "Chemin des logs",
  "twa.source": "Source",
  "twa.open": "Ouvrir",
  "twa.schemeUnknown": "inconnu",
  "twa.schemePvc": "sous-chemin PVC",
  "twa.schemeGcs": "bucket GCS (traces de torch.profiler)",
  "twa.schemeS3": "bucket S3",
  "twa.schemePath": "chemin",
  "twa.profilerHintPre":
    "les chemins gs:// servent des traces du profileur (*.pt.trace.json) " +
    "capturées avec ",
  "twa.profilerHintPost":
    " — ouvrez l'onglet Profile dans TensorBoard ; son bouton Capture " +
    "enregistre en direct un *.xplane.pb d'un notebook qui a lancé " +
    "sdk.start_profiler_server().",
  "twa.events": "Événements",
  "twa.noEvents": "Aucun événement.",
  "twa.deleteTitle": "Supprimer le TensorBoard {name} ?",
  "twa.deleteMessage":
    "Le serveur est supprimé ; les logs eux-mêmes sont conservés.",
  "twa.deleting": "Suppression de {name}",
  "twa.empty": "Aucun TensorBoard dans ce namespace.",
  "twa.fixName": "Corrigez d'abord le nom.",
  "twa.creating": "Création du TensorBoard {name}",
  "twa.title": "TensorBoards",
  "twa.namespace": "namespace",
  "twa.newTensorboard": "+ Nouveau TensorBoard",
  "twa.formTitle": "Nouveau TensorBoard",
  "twa.formName": "Nom",
  "twa.formLogspath": "Chemin des logs",
  "twa.formProfiler": "Profileur PyTorch",
  "twa.create": "Créer",
});

let tablePoller = null;

function schemeOf(logspath) {
  if (!logspath) return KF.t("twa.schemeUnknown");
  if (logspath.startsWith("pvc://")) return KF.t("twa.schemePvc");
  if (logspath.startsWith("gs://")) return KF.t("twa.schemeGcs");
  if (logspath.startsWith("s3://")) return KF.t("twa.schemeS3");
  return KF.t("twa.schemePath");
}

function openDetails(tb) {
  const drawer = KF.drawer(KF.t("twa.drawerTitle", { name: tb.name }));
  const eventsHost = el("div", {});
  drawer.content.append(
    KF.detailsList([
      [KF.t("table.name"), tb.name],
      [KF.t("table.status"), KF.statusDot(tb.ready ? "ready" : "waiting", "")],
      [KF.t("twa.logsPath"), tb.logspath],
      [KF.t("twa.source"), schemeOf(tb.logspath)],
      [
        KF.t("twa.open"),
        el(
          "a",
          { href: KF.urls.tensorboard(ns.get(), tb.name), target: "_blank" },
          KF.urls.tensorboard(ns.get(), tb.name)
        ),
      ],
    ]),
    el(
      "p",
      { class: "muted" },
      KF.t("twa.profilerHintPre"),
      el("code", {}, "torch.profiler"),
      KF.t("twa.profilerHintPost")
    ),
    el("h4", {}, KF.t("twa.events")),
    eventsHost
  );
  api(`api/namespaces/${ns.get()}/tensorboards/${tb.name}/events`).then(
    (body) => KF.eventsTable(eventsHost, body.events),
    () => eventsHost.append(el("p", { class: "muted" }, KF.t("twa.noEvents")))
  );
}

async function refresh() {
  const body = await api(`api/namespaces/${ns.get()}/tensorboards`);
  const columns = [
    {
      title: () => KF.t("table.status"),
      render: (tb) => statusDot(tb.ready ? "ready" : "waiting", ""),
      sortKey: (tb) => (tb.ready ? 0 : 1),
    },
    { title: () => KF.t("table.name"),
      render: (tb) => tb.name, sortKey: (tb) => tb.name },
    {
      title: () => KF.t("twa.logsPath"),
      render: (tb) => tb.logspath,
      sortKey: (tb) => tb.logspath || "",
    },
    { title: () => KF.t("twa.source"),
      render: (tb) => schemeOf(tb.logspath) },
    {
      title: () => KF.t("table.actions"),
      render: (tb) =>
        el(
          "span",
          {},
          el(
            "a",
            {
              href: KF.urls.tensorboard(ns.get(), tb.name),
              target: "_blank",
              onclick: (ev) => ev.stopPropagation(),
            },
            KF.t("twa.open")
          ),
          " ",
          KF.actionButton(
            KF.t("action.delete"),
            () =>
              KF.confirmDialog({
                title: KF.t("twa.deleteTitle", { name: tb.name }),
                message: KF.t("twa.deleteMessage"),
              }).then(
                (ok) =>
                  ok &&
                  api(`api/namespaces/${ns.get()}/tensorboards/${tb.name}`, {
                    method: "DELETE",
                  }).then(() => {
                    KF.snackbar(KF.t("twa.deleting", { name: tb.name }));
                    tablePoller.refresh();
                  }, showError)
              ),
            { class: "danger" }
          )
        ),
    },
  ];
  renderTable(document.getElementById("tb-table"), columns, body.tensorboards, {
    onRowClick: openDetails,
    emptyText: KF.t("twa.empty"),
    pageSize: 25,
    filterable: true,
  });
}

const nameInput = document.querySelector('#new-form input[name="name"]');
const nameCheck = nameInput
  ? KF.validate(nameInput, KF.validators.dns1123)
  : () => true;

document.getElementById("new-btn").addEventListener("click", () => {
  document.getElementById("new-form-card").style.display = "block";
});
document.getElementById("cancel-btn").addEventListener("click", () => {
  document.getElementById("new-form-card").style.display = "none";
});
document.getElementById("new-form").addEventListener("submit", (ev) => {
  ev.preventDefault();
  if (!nameCheck()) return KF.snackbar(KF.t("twa.fixName"), "error");
  const form = new FormData(ev.target);
  api(`api/namespaces/${ns.get()}/tensorboards`, {
    method: "POST",
    body: JSON.stringify({
      name: form.get("name"),
      logspath: form.get("logspath"),
      profilerPlugin: form.get("profiler") === "on",
    }),
  }).then(() => {
    document.getElementById("new-form-card").style.display = "none";
    KF.snackbar(KF.t("twa.creating", { name: form.get("name") }));
    tablePoller.refresh();
  }, showError);
});

async function loadLogspathSuggestions() {
  /* pvc:// + gs:// templates for the logspath field, fed by the backend's
   * pvcs route (reference TWA form). */
  const input = document.querySelector('input[name="logspath"]');
  if (!input) return;
  let datalist = document.getElementById("logspath-options");
  if (!datalist) {
    datalist = el("datalist", { id: "logspath-options" });
    document.body.append(datalist);
    input.setAttribute("list", "logspath-options");
  }
  const body = await api(`api/namespaces/${ns.get()}/pvcs`).catch(() => ({
    pvcs: [],
  }));
  datalist.replaceChildren(
    ...body.pvcs.map((p) => el("option", { value: `pvc://${p.name}/logs` })),
    el("option", { value: "gs://your-bucket/tensorboard" })
  );
}

document.getElementById("ns-slot").append(
  namespacePicker(() => {
    tablePoller.refresh();
    loadLogspathSuggestions();
  }),
  " ",
  KF.localePicker()
);
KF.localizeDocument();
KF.onLocaleChange(() => refresh().catch(() => {}));
tablePoller = poll(refresh);
loadLogspathSuggestions();
