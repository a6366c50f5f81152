/* VWA frontend: PVC table with viewer lifecycle + details drawer.
 *
 * The reference's Angular volumes app on the shared KF lib: sortable
 * table, confirm dialogs, snackbars, and a per-PVC drawer with details,
 * live events (backend /pvcs/{name}/events) and YAML. All user-visible
 * strings route through KF.t (reference: the volumes frontend's xlf
 * translation pipeline, i18n/fr/messages.fr.xlf). */

KF.registerMessages("en", {
  "vwa.drawerTitle": "Volume {name}",
  "vwa.tabOverview": "Overview",
  "vwa.tabEvents": "Events",
  "vwa.capacity": "Capacity",
  "vwa.accessModes": "Access modes",
  "vwa.storageClass": "Storage class",
  "vwa.classDefault": "default",
  "vwa.usedBy": "Used by",
  "vwa.usedByNothing": "nothing",
  "vwa.viewer": "Viewer",
  "vwa.viewerOpen": "open",
  "vwa.viewerStarting": "starting…",
  "vwa.viewerNone": "none",
  "vwa.colSize": "Size",
  "vwa.colModes": "Modes",
  "vwa.colUsedBy": "Used by",
  "vwa.browse": "Browse",
  "vwa.viewerStartingBtn": "Viewer starting…",
  "vwa.openViewer": "Open viewer",
  "vwa.closeViewer": "Close viewer",
  "vwa.startingViewerFor": "Starting viewer for {name}",
  "vwa.deleteTitle": "Delete volume {name}?",
  "vwa.deleteMessage": "All data on the volume is permanently removed.",
  "vwa.deleting": "Deleting {name}",
  "vwa.empty": "No volumes in this namespace.",
  "vwa.fixName": "Fix the volume name first.",
  "vwa.creating": "Creating volume {name}",
  "vwa.title": "Volumes",
  "vwa.namespace": "namespace",
  "vwa.newVolume": "+ New volume",
  "vwa.formTitle": "New volume",
  "vwa.formName": "Name",
  "vwa.formSize": "Size",
  "vwa.formAccessMode": "Access mode",
  "vwa.create": "Create",
  "vwa.loading": "Loading…",
});
KF.registerMessages("de", {
  "vwa.drawerTitle": "Volume {name}",
  "vwa.tabOverview": "Übersicht",
  "vwa.tabEvents": "Ereignisse",
  "vwa.capacity": "Kapazität",
  "vwa.accessModes": "Zugriffsmodi",
  "vwa.storageClass": "Speicherklasse",
  "vwa.classDefault": "Standard",
  "vwa.usedBy": "Verwendet von",
  "vwa.usedByNothing": "nichts",
  "vwa.viewer": "Viewer",
  "vwa.viewerOpen": "öffnen",
  "vwa.viewerStarting": "startet…",
  "vwa.viewerNone": "keiner",
  "vwa.colSize": "Größe",
  "vwa.colModes": "Modi",
  "vwa.colUsedBy": "Verwendet von",
  "vwa.browse": "Durchsuchen",
  "vwa.viewerStartingBtn": "Viewer startet…",
  "vwa.openViewer": "Viewer öffnen",
  "vwa.closeViewer": "Viewer schließen",
  "vwa.startingViewerFor": "Viewer für {name} wird gestartet",
  "vwa.deleteTitle": "Volume {name} löschen?",
  "vwa.deleteMessage": "Alle Daten auf dem Volume werden endgültig entfernt.",
  "vwa.deleting": "{name} wird gelöscht",
  "vwa.empty": "Keine Volumes in diesem Namespace.",
  "vwa.fixName": "Bitte zuerst den Volume-Namen korrigieren.",
  "vwa.creating": "Volume {name} wird erstellt",
  "vwa.title": "Volumes",
  "vwa.namespace": "Namespace",
  "vwa.newVolume": "+ Neues Volume",
  "vwa.formTitle": "Neues Volume",
  "vwa.formName": "Name",
  "vwa.formSize": "Größe",
  "vwa.formAccessMode": "Zugriffsmodus",
  "vwa.create": "Erstellen",
  "vwa.loading": "Lädt…",
});
KF.registerMessages("fr", {
  "vwa.drawerTitle": "Volume {name}",
  "vwa.tabOverview": "Aperçu",
  "vwa.tabEvents": "Événements",
  "vwa.capacity": "Capacité",
  "vwa.accessModes": "Modes d'accès",
  "vwa.storageClass": "Classe de stockage",
  "vwa.classDefault": "défaut",
  "vwa.usedBy": "Utilisé par",
  "vwa.usedByNothing": "rien",
  "vwa.viewer": "Visionneuse",
  "vwa.viewerOpen": "ouvrir",
  "vwa.viewerStarting": "démarrage…",
  "vwa.viewerNone": "aucune",
  "vwa.colSize": "Taille",
  "vwa.colModes": "Modes",
  "vwa.colUsedBy": "Utilisé par",
  "vwa.browse": "Parcourir",
  "vwa.viewerStartingBtn": "Visionneuse en démarrage…",
  "vwa.openViewer": "Ouvrir la visionneuse",
  "vwa.closeViewer": "Fermer la visionneuse",
  "vwa.startingViewerFor": "Démarrage de la visionneuse pour {name}",
  "vwa.deleteTitle": "Supprimer le volume {name} ?",
  "vwa.deleteMessage":
    "Toutes les données du volume seront définitivement supprimées.",
  "vwa.deleting": "Suppression de {name}",
  "vwa.empty": "Aucun volume dans ce namespace.",
  "vwa.fixName": "Corrigez d'abord le nom du volume.",
  "vwa.creating": "Création du volume {name}",
  "vwa.title": "Volumes",
  "vwa.namespace": "namespace",
  "vwa.newVolume": "+ Nouveau volume",
  "vwa.formTitle": "Nouveau volume",
  "vwa.formName": "Nom",
  "vwa.formSize": "Taille",
  "vwa.formAccessMode": "Mode d'accès",
  "vwa.create": "Créer",
  "vwa.loading": "Chargement…",
});

let tablePoller = null;

function openDetails(p) {
  const drawer = KF.drawer(KF.t("vwa.drawerTitle", { name: p.name }));
  const tabHost = el("div", {});
  drawer.content.append(tabHost);
  const tabs = KF.tabs(tabHost, [
    {
      label: KF.t("vwa.tabOverview"),
      render: (pane) => {
        pane.append(
          KF.detailsList([
            [KF.t("table.name"), p.name],
            [KF.t("vwa.capacity"), p.capacity || "—"],
            [KF.t("vwa.accessModes"), (p.modes || []).join(", ")],
            [KF.t("vwa.storageClass"), p.class || KF.t("vwa.classDefault")],
            [KF.t("table.status"), p.status],
            [
              KF.t("vwa.usedBy"),
              (p.usedBy || []).length
                ? el(
                    "span",
                    {},
                    p.usedBy.map((name) => el("span", { class: "chip" }, name))
                  )
                : KF.t("vwa.usedByNothing"),
            ],
            [
              KF.t("vwa.viewer"),
              p.viewer
                ? p.viewer.ready && p.viewer.url
                  ? el("a", { href: p.viewer.url, target: "_blank" },
                       KF.t("vwa.viewerOpen"))
                  : KF.t("vwa.viewerStarting")
                : KF.t("vwa.viewerNone"),
            ],
          ])
        );
      },
    },
    {
      label: KF.t("vwa.tabEvents"),
      render: (pane) => {
        const host = el("div", {});
        pane.append(host);
        async function load() {
          const body = await api(
            `api/namespaces/${ns.get()}/pvcs/${p.name}/events`
          );
          KF.eventsTable(host, body.events);
        }
        load().catch(KF.showError);
        const t = setInterval(() => load().catch(() => {}), 5000);
        return { stop: () => clearInterval(t) };
      },
    },
  ]);
  drawer.onclose = () => tabs.stop();
}

async function refresh() {
  const body = await api(`api/namespaces/${ns.get()}/pvcs`);
  const columns = [
    { title: () => KF.t("table.name"),
      render: (p) => p.name, sortKey: (p) => p.name },
    {
      title: () => KF.t("vwa.colSize"),
      render: (p) => p.capacity || "—",
      sortKey: (p) => p.capacity || "",
    },
    { title: () => KF.t("vwa.colModes"),
      render: (p) => (p.modes || []).join(", ") },
    { title: () => KF.t("table.status"),
      render: (p) => p.status, sortKey: (p) => p.status },
    {
      title: () => KF.t("vwa.colUsedBy"),
      render: (p) =>
        (p.usedBy || []).length
          ? p.usedBy.map((name) => el("span", { class: "chip" }, name))
          : "—",
    },
    {
      title: () => KF.t("table.actions"),
      render: (p) =>
        el(
          "span",
          {},
          p.viewer && p.viewer.ready && p.viewer.url
            ? el(
                "a",
                {
                  href: p.viewer.url,
                  target: "_blank",
                  onclick: (ev) => ev.stopPropagation(),
                },
                KF.t("vwa.browse")
              )
            : KF.actionButton(
                p.viewer ? KF.t("vwa.viewerStartingBtn")
                         : KF.t("vwa.openViewer"),
                () =>
                  api(`api/namespaces/${ns.get()}/viewers`, {
                    method: "POST",
                    body: JSON.stringify({ pvc: p.name }),
                  }).then(() => {
                    KF.snackbar(
                      KF.t("vwa.startingViewerFor", { name: p.name }));
                    tablePoller.refresh();
                  }, showError)
              ),
          " ",
          p.viewer
            ? KF.actionButton(KF.t("vwa.closeViewer"), () =>
                api(`api/namespaces/${ns.get()}/viewers/${p.viewer.name}`, {
                  method: "DELETE",
                }).then(() => tablePoller.refresh(), showError)
              )
            : "",
          " ",
          KF.actionButton(
            KF.t("action.delete"),
            () =>
              KF.confirmDialog({
                title: KF.t("vwa.deleteTitle", { name: p.name }),
                message: KF.t("vwa.deleteMessage"),
              }).then(
                (ok) =>
                  ok &&
                  api(`api/namespaces/${ns.get()}/pvcs/${p.name}`, {
                    method: "DELETE",
                  }).then(() => {
                    KF.snackbar(KF.t("vwa.deleting", { name: p.name }));
                    tablePoller.refresh();
                  }, showError)
              ),
            { class: "danger" }
          )
        ),
    },
  ];
  renderTable(document.getElementById("pvc-table"), columns, body.pvcs, {
    onRowClick: openDetails,
    emptyText: KF.t("vwa.empty"),
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
  if (!nameCheck()) return KF.snackbar(KF.t("vwa.fixName"), "error");
  const form = new FormData(ev.target);
  api(`api/namespaces/${ns.get()}/pvcs`, {
    method: "POST",
    body: JSON.stringify({
      name: form.get("name"),
      size: form.get("size"),
      mode: form.get("mode"),
    }),
  }).then(() => {
    document.getElementById("new-form-card").style.display = "none";
    KF.snackbar(KF.t("vwa.creating", { name: form.get("name") }));
    tablePoller.refresh();
  }, showError);
});

document
  .getElementById("ns-slot")
  .append(namespacePicker(() => tablePoller.refresh()), " ", KF.localePicker());
KF.localizeDocument();
KF.onLocaleChange(() => refresh().catch(() => {}));
tablePoller = poll(refresh);
