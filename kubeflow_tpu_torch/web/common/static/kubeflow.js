/* Shared frontend library for the kubeflow-tpu web apps.
 *
 * Buildless equivalent of the reference's kubeflow-common-lib
 * (crud-web-apps/common/frontend/kubeflow-common-lib/projects/kubeflow/src/lib):
 * backend service w/ CSRF header injection, exponential-backoff poller,
 * resource-table (dynamic columns, status icons, sorting, row actions),
 * logs-viewer, conditions-table, events-table, details-list,
 * confirm-dialog, snack-bar, namespace selector, form validators,
 * date-time utils, tabs, a YAML view, a details drawer, a GPU slice
 * rollup panel and a dependency-free sparkline — one namespace (KF), no
 * framework, no bundler.
 *
 * Backward-compatible globals (api, el, ns, renderTable, statusDot,
 * namespacePicker, showError, poll) are kept as aliases at the bottom.
 */

const KF = {};

/* ---------------- i18n (reference: frontends' translation infra) --------
 *
 * Message-catalog layer: KF.t(key, params) resolves through the active
 * locale's catalog, falls back to English, then to the key itself.
 * Catalogs are plain objects; apps extend them with KF.registerMessages.
 * The chosen locale persists in localStorage and a change notifies
 * subscribers so live views re-render in place. */

KF.i18n = {
  locale: "en",
  fallback: "en",
  catalogs: { en: {}, de: {}, fr: {} },
  listeners: [],
  available: function () {
    return Object.keys(KF.i18n.catalogs).sort();
  },
};

KF.registerMessages = function (locale, messages) {
  KF.i18n.catalogs[locale] = Object.assign(
    KF.i18n.catalogs[locale] || {},
    messages
  );
};

KF.hasMessage = function (key) {
  const cat = KF.i18n.catalogs[KF.i18n.locale] || {};
  const fall = KF.i18n.catalogs[KF.i18n.fallback] || {};
  return cat[key] !== undefined || fall[key] !== undefined;
};

KF.t = function (key, params) {
  const cat = KF.i18n.catalogs[KF.i18n.locale] || {};
  const fall = KF.i18n.catalogs[KF.i18n.fallback] || {};
  let msg = cat[key];
  if (msg === undefined) msg = fall[key];
  if (msg === undefined) msg = key;
  if (params) {
    for (const [k, v] of Object.entries(params)) {
      msg = msg.split("{" + k + "}").join(String(v));
    }
  }
  return msg;
};

KF.setLocale = function (locale) {
  KF.i18n.locale = locale;
  try {
    localStorage.setItem("kf.locale", locale);
  } catch (err) {
    /* storage-less context (sandboxed iframe) — session-only locale */
  }
  for (const fn of KF.i18n.listeners.slice()) {
    try {
      fn(locale);
    } catch (err) {
      /* one subscriber's render error must not stop the others */
    }
  }
};

KF.onLocaleChange = function (fn) {
  KF.i18n.listeners.push(fn);
  return function () {
    const at = KF.i18n.listeners.indexOf(fn);
    if (at >= 0) KF.i18n.listeners.splice(at, 1);
  };
};

/* Static-HTML localization: elements marked data-i18n="key" get their
 * text from the catalog; data-i18n-attr="placeholder:key;title:key2"
 * localizes attributes. The first call subscribes to locale changes so
 * the static chrome re-renders with the dynamic views. */
KF.localizeDocument = function (root) {
  const scope = root || document;
  for (const node of scope.querySelectorAll("[data-i18n]")) {
    node.textContent = KF.t(node.getAttribute("data-i18n"));
  }
  for (const node of scope.querySelectorAll("[data-i18n-attr]")) {
    for (const pair of node.getAttribute("data-i18n-attr").split(";")) {
      const at = pair.indexOf(":");
      if (at > 0) {
        node.setAttribute(pair.slice(0, at), KF.t(pair.slice(at + 1)));
      }
    }
  }
  if (!KF.localizeDocument._subscribed) {
    KF.localizeDocument._subscribed = true;
    KF.onLocaleChange(() => KF.localizeDocument(root));
  }
};

KF.localePicker = function () {
  const select = document.createElement("select");
  select.className = "kf-locale-picker";
  select.setAttribute("aria-label", "language");
  select.style.width = "auto";
  for (const loc of KF.i18n.available()) {
    const opt = document.createElement("option");
    opt.value = loc;
    opt.append(document.createTextNode(loc));
    if (loc === KF.i18n.locale) opt.setAttribute("selected", "selected");
    select.append(opt);
  }
  select.addEventListener("change", () => KF.setLocale(select.value));
  return select;
};

/* Common-lib message catalogs. English is the fallback source of truth;
 * German proves the pipe end-to-end (picker → setLocale → re-render). */
KF.registerMessages("en", {
  "status.ready": "Running",
  "status.waiting": "Starting",
  "status.warning": "Error",
  "status.terminating": "Deleting",
  "status.stopped": "Stopped",
  "table.status": "Status",
  "table.name": "Name",
  "table.image": "Image",
  "table.cpu": "CPU",
  "table.memory": "Memory",
  "table.gpu": "GPU",
  "table.age": "Age",
  "table.lastActivity": "Last activity",
  "table.actions": "Actions",
  "table.filterPlaceholder": "Filter rows",
  "table.noMatches": 'No rows match "{query}".',
  "table.prevPage": "Previous",
  "table.nextPage": "Next",
  "table.pageInfo": "{first}–{last} of {total}",
  "action.start": "Start",
  "action.stop": "Stop",
  "action.delete": "Delete",
  "action.connect": "Connect",
  "common.none": "none",
  "common.cancel": "Cancel",
  "common.loading": "Loading…",
  "common.apply": "Apply",
  "common.chipPlaceholder": "add value, press Enter",
  "jwa.empty": "No notebook servers in this namespace.",
});
KF.registerMessages("de", {
  "status.ready": "Läuft",
  "status.waiting": "Startet",
  "status.warning": "Fehler",
  "status.terminating": "Wird gelöscht",
  "status.stopped": "Gestoppt",
  "table.status": "Status",
  "table.name": "Name",
  "table.image": "Image",
  "table.cpu": "CPU",
  "table.memory": "Speicher",
  "table.gpu": "GPU",
  "table.age": "Alter",
  "table.lastActivity": "Letzte Aktivität",
  "table.actions": "Aktionen",
  "table.filterPlaceholder": "Zeilen filtern",
  "table.noMatches": 'Keine Zeilen passen auf "{query}".',
  "table.prevPage": "Zurück",
  "table.nextPage": "Weiter",
  "table.pageInfo": "{first}–{last} von {total}",
  "action.start": "Starten",
  "action.stop": "Stoppen",
  "action.delete": "Löschen",
  "action.connect": "Verbinden",
  "common.none": "keine",
  "common.cancel": "Abbrechen",
  "common.loading": "Lädt…",
  "common.apply": "Übernehmen",
  "common.chipPlaceholder": "Wert eingeben, Enter drücken",
  "jwa.empty": "Keine Notebook-Server in diesem Namespace.",
});
/* French — the locale the reference actually ships xlf catalogs for
 * (volumes/frontend/i18n/fr/messages.fr.xlf). */
KF.registerMessages("fr", {
  "status.ready": "En cours",
  "status.waiting": "Démarrage",
  "status.warning": "Erreur",
  "status.terminating": "Suppression",
  "status.stopped": "Arrêté",
  "table.status": "Statut",
  "table.name": "Nom",
  "table.image": "Image",
  "table.cpu": "CPU",
  "table.memory": "Mémoire",
  "table.gpu": "GPU",
  "table.age": "Âge",
  "table.lastActivity": "Dernière activité",
  "table.actions": "Actions",
  "table.filterPlaceholder": "Filtrer les lignes",
  "table.noMatches": 'Aucune ligne ne correspond à "{query}".',
  "table.prevPage": "Précédent",
  "table.nextPage": "Suivant",
  "table.pageInfo": "{first}–{last} sur {total}",
  "action.start": "Démarrer",
  "action.stop": "Arrêter",
  "action.delete": "Supprimer",
  "action.connect": "Connecter",
  "common.none": "aucun",
  "common.cancel": "Annuler",
  "common.loading": "Chargement…",
  "common.apply": "Appliquer",
  "common.chipPlaceholder": "saisir une valeur, puis Entrée",
  "jwa.empty": "Aucun serveur de notebooks dans ce namespace.",
});

/* Restore the persisted locale (after the catalogs exist). */
try {
  const saved = localStorage.getItem("kf.locale");
  if (saved) KF.i18n.locale = saved;
} catch (err) {
  /* storage-less context: default locale */
}

/* ---------------- backend service (lib/services/backend) ---------------- */

KF.getCookie = function (name) {
  const m = document.cookie.match(new RegExp("(?:^|; )" + name + "=([^;]*)"));
  return m ? decodeURIComponent(m[1]) : null;
};

KF.api = async function (path, options = {}) {
  const headers = Object.assign(
    { "Content-Type": "application/json" },
    options.headers || {}
  );
  const method = (options.method || "GET").toUpperCase();
  if (method !== "GET" && method !== "HEAD") {
    const token = KF.getCookie("XSRF-TOKEN");
    if (token) headers["X-XSRF-TOKEN"] = token;
  }
  const resp = await fetch(path, Object.assign({}, options, { headers }));
  const body = await resp.json().catch(() => ({}));
  if (!resp.ok || body.success === false) {
    throw new Error(body.log || resp.status + " " + resp.statusText);
  }
  return body;
};

/* ---------------- DOM helper ------------------------------------------- */

KF.el = function (tag, attrs = {}, ...children) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) {
    if (v === undefined || v === null) continue; // e.g. conditional disabled
    if (k.startsWith("on") && typeof v === "function") {
      node.addEventListener(k.slice(2), v);
    } else if (k === "class") node.className = v;
    else if (k === "style" && typeof v === "object") Object.assign(node.style, v);
    else node.setAttribute(k, v);
  }
  for (const child of children.flat(Infinity)) {
    if (child == null) continue;
    node.append(child instanceof Node ? child : document.createTextNode(child));
  }
  return node;
};

/* ---------------- poller (lib/polling) --------------------------------- */

/* Exponential-backoff poller like the reference's Poller: on success the
 * period resets to `base`; on failure it doubles up to `max`. stop() ends
 * it; the returned handle exposes refresh() for user-triggered reloads. */
KF.poller = function (fn, { base = 4000, max = 60000 } = {}) {
  let period = base;
  let timer = null;
  let stopped = false;
  async function tick(showErrors) {
    try {
      await fn();
      period = base;
    } catch (err) {
      period = Math.min(period * 2, max);
      if (showErrors) KF.showError(err);
    }
    if (!stopped) timer = setTimeout(() => tick(false), period);
  }
  tick(true);
  return {
    stop() {
      stopped = true;
      clearTimeout(timer);
    },
    refresh() {
      clearTimeout(timer);
      return tick(true);
    },
  };
};

/* ---------------- status icon (lib/resource-table/status) --------------- */

KF.STATUS_TITLES = {
  ready: "Running",
  waiting: "Starting",
  warning: "Error",
  terminating: "Deleting",
  stopped: "Stopped",
};

KF.statusDot = function (phase, message) {
  const label = KF.hasMessage("status." + phase)
    ? KF.t("status." + phase)
    : KF.STATUS_TITLES[phase] || phase;
  return KF.el(
    "span",
    { class: "status", title: message || "" },
    KF.el("span", { class: "dot " + phase, "aria-hidden": "true" }),
    label
  );
};

/* ---------------- date-time (lib/date-time) ----------------------------- */

KF.age = function (timestamp) {
  if (!timestamp) return "—";
  const sec = Math.max(0, (Date.now() - Date.parse(timestamp)) / 1000);
  if (sec < 120) return Math.floor(sec) + "s";
  if (sec < 7200) return Math.floor(sec / 60) + "m";
  if (sec < 172800) return Math.floor(sec / 3600) + "h";
  return Math.floor(sec / 86400) + "d";
};

/* Absolute timestamp, UTC, second resolution — the tooltip form of the
 * reference's date-time module ("2026-07-30 09:14:05 UTC"). */
KF.formatDate = function (timestamp) {
  if (!timestamp) return "—";
  const d = new Date(Date.parse(timestamp));
  const pad = (n) => String(n).padStart(2, "0");
  return (
    d.getUTCFullYear() + "-" + pad(d.getUTCMonth() + 1) + "-" +
    pad(d.getUTCDate()) + " " + pad(d.getUTCHours()) + ":" +
    pad(d.getUTCMinutes()) + ":" + pad(d.getUTCSeconds()) + " UTC"
  );
};

/* Relative age with the absolute time as a hover tooltip — what every
 * "Age"/"Last activity" table cell should render. */
KF.ageCell = function (timestamp, suffix) {
  return KF.el(
    "span",
    { class: "kf-age", title: KF.formatDate(timestamp) },
    KF.age(timestamp) + (timestamp && suffix ? suffix : "")
  );
};

/* ---------------- resource table (lib/resource-table) ------------------- */

/* columns: [{title, render(row) -> Node|string, sortKey?(row) -> any}]
 * opts: {onRowClick(row), emptyText} — rows get a click affordance when
 * onRowClick is provided (the reference's details navigation). */
KF.renderTable = function (container, columns, rows, opts = {}) {
  const state = (container._kfSort = container._kfSort || { idx: -1, dir: 1 });
  // Filter + pagination state live with the sort state so a data poll
  // re-render keeps the user's page and query (reference resource-table:
  // MatPaginator + filter predicate).
  if (state.page === undefined) state.page = 0;
  if (state.query === undefined) state.query = "";
  let filtered = rows;
  if (opts.filterable && state.query) {
    const q = state.query.toLowerCase();
    // Match on what the user SEES (the referenced MatTable filters
    // displayed data): each cell's RENDERED text, minus button labels —
    // raw row fields would false-match on invisible data (ISO
    // timestamps rendered as ages, raw phase keys rendered as localized
    // labels) and never match computed cells, while action-button
    // labels ("Delete") would match every row. Button text is excluded
    // STRUCTURALLY (skip the button subtree while walking) rather than
    // by substring removal from the row's text — a row whose own data
    // contains "Delete" must stay matchable.
    const cellText = (v) => {
      if (v == null) return "";
      if (typeof v === "string" || typeof v === "number") return String(v);
      if (Array.isArray(v)) return v.map(cellText).join(" ");
      // Text leaves FIRST: in a real browser Text nodes expose a (defined,
      // empty) childNodes NodeList, so the element walk below would
      // otherwise reduce every text leaf to "".
      if (v.nodeType === 3) return v.textContent || "";
      if (v.tagName === "BUTTON") return " ";
      if (v.childNodes !== undefined) {
        let text = "";
        for (const child of v.childNodes) text += cellText(child);
        return text;
      }
      return v.textContent !== undefined ? v.textContent : "";
    };
    // Per-row filter text is computed ONCE per rows array (and locale)
    // and reused across keystrokes — re-invoking every column's
    // render() per keystroke scaled as rows × columns × keypresses. A
    // data poll passes a fresh rows array, which invalidates the cache.
    let cache = container._kfFilterText;
    if (!cache || cache.rows !== rows || cache.locale !== KF.i18n.locale) {
      cache = container._kfFilterText = {
        rows,
        locale: KF.i18n.locale,
        text: rows.map((row) =>
          columns
            .map((c) => cellText(c.render(row)))
            .join(" ")
            .toLowerCase()
        ),
      };
    }
    filtered = rows.filter((row, i) => cache.text[i].includes(q));
  }
  const pageSize = opts.pageSize || 0;
  const pages = pageSize ? Math.max(1, Math.ceil(filtered.length / pageSize))
                         : 1;
  if (state.page >= pages) state.page = pages - 1;
  const sorted = filtered.slice();
  if (state.idx >= 0 && columns[state.idx] && columns[state.idx].sortKey) {
    const key = columns[state.idx].sortKey;
    sorted.sort((a, b) => {
      const [ka, kb] = [key(a), key(b)];
      return (ka > kb ? 1 : ka < kb ? -1 : 0) * state.dir;
    });
  }
  const pageRows = pageSize
    ? sorted.slice(state.page * pageSize, (state.page + 1) * pageSize)
    : sorted;
  // Stashed on the container so long-lived listeners (the reused filter
  // input) always re-render with the LATEST rows, not the closure from
  // the render that created them.
  const rerender = container._kfRerender =
    () => KF.renderTable(container, columns, rows, opts);
  const head = KF.el(
    "tr",
    {},
    columns.map((c, idx) => {
      /* title may be a thunk (e.g. () => KF.t(...)) so headers follow
       * the active locale on every render. */
      const label = typeof c.title === "function" ? c.title() : c.title;
      if (!c.sortKey) return KF.el("th", { scope: "col" }, label);
      /* a11y: the WAI-ARIA sortable-table pattern — the <th> KEEPS its
       * columnheader semantics (scope=col, aria-sort lives here; it is
       * only valid on column/row headers) and the interactive part is a
       * real <button> nested inside. After the sort re-render, focus is
       * restored onto the same column's button, so keyboard users can
       * toggle direction without re-tabbing through the page. */
      const sort = () => {
        state.dir = state.idx === idx ? -state.dir : 1;
        state.idx = idx;
        state.refocus = idx;
        KF.renderTable(container, columns, rows, opts);
      };
      return KF.el(
        "th",
        {
          scope: "col",
          class: "sortable" + (state.idx === idx ? " sorted" : ""),
          "aria-sort":
            state.idx !== idx
              ? "none"
              : state.dir > 0
                ? "ascending"
                : "descending",
        },
        KF.el(
          "button",
          { class: "kf-sort-btn", onclick: sort },
          label,
          state.idx === idx ? (state.dir > 0 ? " ▲" : " ▼") : ""
        )
      );
    })
  );
  const body = pageRows.length
    ? pageRows.map((row) =>
        KF.el(
          "tr",
          opts.onRowClick
            ? {
                class: "clickable",
                tabindex: "0",
                onclick: () => opts.onRowClick(row),
                onkeydown: (ev) => {
                  /* Only when the ROW itself is focused: Enter on a
                   * nested action button bubbles here too, and firing
                   * the row would stack the drawer on the button's own
                   * dialog. */
                  const within = ev.target && ev.target.closest &&
                    ev.target.closest("button, a, input, select, textarea");
                  if (ev.key === "Enter" && !within) opts.onRowClick(row);
                  /* Arrow-key roving between data rows (WAI-ARIA grid
                   * navigation): focus moves to the adjacent clickable
                   * row without tabbing through its action buttons. */
                  if ((ev.key === "ArrowDown" || ev.key === "ArrowUp") &&
                      !within) {
                    const tr = ev.target.closest("tr");
                    const sib = tr && (ev.key === "ArrowDown"
                      ? tr.nextElementSibling
                      : tr.previousElementSibling);
                    if (sib && sib.focus) {
                      ev.preventDefault();
                      sib.focus();
                    }
                  }
                },
              }
            : {},
          columns.map((c) => KF.el("td", {}, c.render(row)))
        )
      )
    : [
        KF.el(
          "tr",
          {},
          KF.el(
            "td",
            { colspan: String(columns.length), class: "muted" },
            rows.length && opts.filterable && state.query
              ? KF.t("table.noMatches", { query: state.query })
              : opts.emptyText || "Nothing here yet."
          )
        ),
      ];
  const chrome = [];
  let refocusFilter = null;
  if (opts.filterable) {
    // The input element is REUSED across re-renders (stashed on the
    // container): replacing it per keystroke would reset the caret
    // position and abort IME composition in a real browser — the
    // oninput handler re-renders only the rows/pager around it.
    let input = container._kfFilterInput;
    if (input && document.activeElement === input) {
      // replaceChildren detaches the element, which drops focus in a
      // real browser (element state — value, selection — survives).
      refocusFilter = input;
    }
    if (!input) {
      input = container._kfFilterInput = KF.el("input", {
        class: "kf-table-filter",
        type: "search",
        value: state.query,
        oninput: (ev) => {
          state.query = (ev.target && ev.target.value) || "";
          state.page = 0;
          container._kfRerender();
        },
      });
    }
    // Placeholder/label follow the active locale on every render.
    input.setAttribute("placeholder", KF.t("table.filterPlaceholder"));
    input.setAttribute("aria-label", KF.t("table.filterPlaceholder"));
    chrome.push(KF.el("div", { class: "kf-table-toolbar" }, input));
  }
  container.replaceChildren(
    ...chrome,
    KF.el("table", {}, KF.el("thead", {}, head), KF.el("tbody", {}, body))
  );
  if (pageSize && (filtered.length > pageSize || state.page > 0)) {
    /* Pager (reference: MatPaginator): range info + prev/next as real
     * buttons, disabled at the bounds, labels localized. */
    const first = state.page * pageSize + 1;
    const last = Math.min(filtered.length, (state.page + 1) * pageSize);
    const move = (delta) => () => {
      state.page += delta;
      rerender();
    };
    container.append(
      KF.el(
        "div",
        { class: "kf-table-pager" },
        KF.el("button", {
          class: "kf-page-prev",
          "aria-label": KF.t("table.prevPage"),
          disabled: state.page === 0 ? "disabled" : undefined,
          onclick: move(-1),
        }, "‹ " + KF.t("table.prevPage")),
        KF.el("span", { class: "kf-page-info", "aria-live": "polite" },
              KF.t("table.pageInfo",
                   { first, last, total: filtered.length })),
        KF.el("button", {
          class: "kf-page-next",
          "aria-label": KF.t("table.nextPage"),
          disabled: state.page >= pages - 1 ? "disabled" : undefined,
          onclick: move(1),
        }, KF.t("table.nextPage") + " ›")
      )
    );
  }
  if (refocusFilter) refocusFilter.focus();
  if (state.refocus !== undefined) {
    const idx = state.refocus;
    delete state.refocus;
    const buttons = container.querySelectorAll("th .kf-sort-btn");
    // nth sortable column: count sortable columns up to idx
    const at = columns.slice(0, idx).filter((c) => c.sortKey).length;
    if (buttons[at]) buttons[at].focus();
  }
};

/* Action buttons that stop row-click propagation (so a Delete click never
 * opens the details drawer underneath it). */
KF.actionButton = function (label, onclick, opts = {}) {
  return KF.el(
    "button",
    {
      class: opts.class || "",
      title: opts.title || "",
      onclick: (ev) => {
        ev.stopPropagation();
        onclick(ev);
      },
    },
    label
  );
};

/* ---------------- details list (lib/details-list) ----------------------- */

KF.detailsList = function (pairs) {
  return KF.el(
    "dl",
    { class: "details-list" },
    pairs
      .filter(([, v]) => v !== undefined && v !== null && v !== "")
      .map(([k, v]) => [
        KF.el("dt", {}, k),
        KF.el("dd", {}, v instanceof Node ? v : String(v)),
      ])
  );
};

/* ---------------- conditions table (lib/conditions-table) --------------- */

KF.conditionsTable = function (container, conditions) {
  KF.renderTable(
    container,
    [
      { title: "Type", render: (c) => c.type || "—" },
      { title: "Status", render: (c) => c.status || "—" },
      { title: "Reason", render: (c) => c.reason || "—" },
      { title: "Message", render: (c) => c.message || "—" },
      {
        title: "Last probe",
        render: (c) => KF.age(c.lastProbeTime || c.lastTransitionTime),
      },
    ],
    conditions || [],
    { emptyText: "No conditions reported." }
  );
};

/* ---------------- events table ------------------------------------------ */

KF.eventsTable = function (container, events) {
  const rows = (events || [])
    .slice()
    .sort((a, b) => (b.lastTimestamp || "").localeCompare(a.lastTimestamp || ""));
  KF.renderTable(
    container,
    [
      {
        title: "Type",
        render: (e) =>
          KF.el(
            "span",
            { class: e.type === "Warning" ? "event-warning" : "" },
            e.type || "Normal"
          ),
      },
      { title: "Reason", render: (e) => e.reason || "—" },
      { title: "Message", render: (e) => e.message || "—" },
      { title: "Count", render: (e) => String(e.count || 1) },
      { title: "Last seen", render: (e) => KF.age(e.lastTimestamp) },
    ],
    rows,
    { emptyText: "No events." }
  );
};

/* ---------------- logs viewer (lib/logs-viewer) ------------------------- */

/* fetchLogs(podName) -> Promise<string[]>; pods: [{name}] for the worker
 * picker (multi-host slices have one log stream per worker). */
KF.logsViewer = function (container, pods, fetchLogs) {
  const pre = KF.el("pre", { class: "logs" }, KF.t("common.loading"));
  const picker = KF.el(
    "select",
    { style: { width: "auto" } },
    (pods || []).map((p) => KF.el("option", { value: p.name }, p.name))
  );
  let timer = null;
  let follow = true;
  async function load() {
    if (!picker.value) {
      pre.textContent = "No pods.";
      return;
    }
    try {
      const lines = await fetchLogs(picker.value);
      pre.textContent = lines.length ? lines.join("\n") : "(no output yet)";
      if (follow) pre.scrollTop = pre.scrollHeight;
    } catch (err) {
      pre.textContent = "Could not fetch logs: " + (err.message || err);
    }
  }
  const followBtn = KF.el(
    "button",
    {
      onclick: () => {
        follow = !follow;
        followBtn.textContent = follow ? "Following ✓" : "Follow";
      },
    },
    "Following ✓"
  );
  const downloadBtn = KF.el(
    "button",
    {
      onclick: () => {
        const blob = new Blob([pre.textContent], { type: "text/plain" });
        const a = KF.el("a", {
          href: URL.createObjectURL(blob),
          download: (picker.value || "pod") + ".log",
        });
        a.click();
        URL.revokeObjectURL(a.href);
      },
    },
    "Download"
  );
  picker.addEventListener("change", load);
  container.replaceChildren(
    KF.el(
      "div",
      { class: "logs-toolbar" },
      KF.el("span", { class: "muted" }, "worker"),
      picker,
      followBtn,
      downloadBtn
    ),
    pre
  );
  load();
  timer = setInterval(load, 5000);
  return {
    stop() {
      clearInterval(timer);
    },
  };
};

/* ---------------- confirm dialog (lib/confirm-dialog) ------------------- */

KF._dialogIds = 0;

/* Modal layering: every modal (dialogs, the drawer) registers here, and
 * only the TOPMOST layer reacts to Escape — a confirm dialog opened from
 * drawer content must not take the drawer down with it. */
KF._modalStack = [];
KF._isTopModal = function (token) {
  return KF._modalStack[KF._modalStack.length - 1] === token;
};
KF._popModal = function (token) {
  const at = KF._modalStack.indexOf(token);
  if (at >= 0) KF._modalStack.splice(at, 1);
};

/* Modal focus trap (WAI-ARIA dialog pattern): Tab/Shift+Tab cycle
 * within the panel instead of escaping into the aria-modal-inerted page
 * behind it. Call from the modal's keydown handler. */
KF._trapTab = function (panel, ev) {
  if (ev.key !== "Tab") return;
  const items = Array.from(
    panel.querySelectorAll(
      "button, a, input, select, textarea, [tabindex]")
  ).filter((n) => !n.disabled && n.getAttribute("tabindex") !== "-1");
  if (!items.length) return;
  const first = items[0];
  const last = items[items.length - 1];
  const active = document.activeElement;
  const inside = panel.contains(active);
  if (ev.shiftKey && (!inside || active === first)) {
    ev.preventDefault();
    last.focus();
  } else if (!ev.shiftKey && (!inside || active === last)) {
    ev.preventDefault();
    first.focus();
  }
};

KF.confirmDialog = function ({ title, message, confirmText }) {
  return new Promise((resolve) => {
    const overlay = KF.el("div", { class: "kf-overlay" });
    const titleId = "kf-dialog-title-" + ++KF._dialogIds;
    const token = {};
    /* a11y: restore focus to the opener when the dialog closes (WAI-ARIA
     * dialog pattern) — keyboard users otherwise land back at <body>. */
    const opener = document.activeElement || null;
    function close(result) {
      overlay.remove();
      document.removeEventListener("keydown", onKey);
      KF._popModal(token);
      if (opener && opener.focus) opener.focus();
      resolve(result);
    }
    function onKey(ev) {
      if (!KF._isTopModal(token)) return;
      if (ev.key === "Escape") close(false);
      else KF._trapTab(panel, ev);
    }
    document.addEventListener("keydown", onKey);
    KF._modalStack.push(token);
    const confirmBtn = KF.el(
      "button",
      { class: "danger", onclick: () => close(true) },
      confirmText || KF.t("action.delete")
    );
    const panel = KF.el(
      "div",
      { class: "kf-dialog", role: "dialog", "aria-modal": "true",
        "aria-labelledby": titleId },
      KF.el("h3", { id: titleId }, title),
      KF.el("p", {}, message),
      KF.el(
        "div",
        { class: "kf-dialog-actions" },
        KF.el("button", { onclick: () => close(false) },
              KF.t("common.cancel")),
        confirmBtn
      )
    );
    overlay.append(panel);
    overlay.addEventListener("click", (ev) => {
      if (ev.target === overlay) close(false);
    });
    document.body.append(overlay);
    confirmBtn.focus();
  });
};

/* ---------------- code editor (lib/editor) ------------------------------ */

/* YAML line tokenizer for the editor's highlight layer: returns a list of
 * spans for one line. Recognizes comments, `key:` heads (with list dashes),
 * quoted strings, numbers, booleans/null. Token classes are kf-tok-*. */
KF.highlightYamlLine = function (line) {
  const out = [];
  const tok = (cls, text) =>
    out.push(KF.el("span", { class: "kf-tok-" + cls }, text));
  // Whole-line comment (possibly indented).
  const cm = line.match(/^(\s*)(#.*)$/);
  if (cm) {
    if (cm[1]) tok("plain", cm[1]);
    tok("comment", cm[2]);
    return out;
  }
  let rest = line;
  // `  - key:` / `key:` head — the indent+dash stays plain, the key colors.
  const km = rest.match(/^(\s*(?:-\s+)?)([A-Za-z0-9_.\/-]+)(:)(\s|$)/);
  if (km) {
    if (km[1]) tok("plain", km[1]);
    tok("key", km[2]);
    tok("plain", km[3] + km[4]);
    rest = rest.slice(km[0].length);
  } else {
    const dm = rest.match(/^(\s*-\s+)/);
    if (dm) {
      tok("plain", dm[1]);
      rest = rest.slice(dm[1].length);
    }
  }
  // Value part: strings / numbers / booleans / trailing comment.
  while (rest.length) {
    let m;
    if ((m = rest.match(/^("[^"]*"?|'[^']*'?)/))) tok("string", m[1]);
    else if ((m = rest.match(/^(#.*)$/))) tok("comment", m[1]);
    else if ((m = rest.match(/^(-?\d+(?:\.\d+)?)(?![A-Za-z0-9_.-])/)))
      tok("number", m[1]);
    else if ((m = rest.match(/^(true|false|null)(?![A-Za-z0-9_-])/)))
      tok("bool", m[1]);
    else if ((m = rest.match(/^(\s+|[^\s"'#]+)/))) tok("plain", m[1]);
    else {
      tok("plain", rest);
      break;
    }
    rest = rest.slice(m[1].length);
  }
  return out;
};

/* Line-numbered, syntax-highlighted editor — the buildless stand-in for
 * the monaco bundle in the reference's lib/editor: a transparent textarea
 * overlaid on a highlight layer, a line-number gutter that tracks edits
 * and scrolling, and Tab inserting two spaces at the caret instead of
 * leaving the field. Returns {root, textarea, getValue, setValue}. */
KF.codeEditor = function (initial, opts = {}) {
  const gutter = KF.el("div", { class: "kf-code-gutter", "aria-hidden": "true" });
  const hl = KF.el("pre", { class: "kf-code-hl", "aria-hidden": "true" });
  const textarea = KF.el("textarea", {
    class: "kf-code-input " + (opts.textareaClass || ""),
    spellcheck: "false",
  });
  textarea.value = initial || "";
  function render() {
    const lines = textarea.value.split("\n");
    gutter.replaceChildren(
      ...lines.map((_, i) => KF.el("div", {}, String(i + 1)))
    );
    hl.replaceChildren(
      ...lines.map((line) =>
        KF.el("div", { class: "kf-code-line" },
          line ? KF.highlightYamlLine(line) : " ")
      )
    );
    if (opts.onChange) opts.onChange(textarea.value);
  }
  textarea.addEventListener("input", render);
  textarea.addEventListener("scroll", () => {
    hl.scrollTop = textarea.scrollTop;
    hl.scrollLeft = textarea.scrollLeft;
    gutter.scrollTop = textarea.scrollTop;
  });
  textarea.addEventListener("keydown", (ev) => {
    if (ev.key !== "Tab") return;
    ev.preventDefault();
    const start = textarea.selectionStart;
    const end = textarea.selectionEnd;
    const v = textarea.value;
    textarea.value = v.slice(0, start) + "  " + v.slice(end);
    textarea.setSelectionRange(start + 2, start + 2);
    render();
  });
  render();
  const root = KF.el(
    "div",
    { class: "kf-code-editor" },
    gutter,
    KF.el("div", { class: "kf-code-area" }, hl, textarea)
  );
  return {
    root,
    textarea,
    getValue() {
      return textarea.value;
    },
    setValue(v) {
      textarea.value = v;
      render();
    },
  };
};

/* ---------------- YAML editor dialog (lib/editor) ----------------------- */

/* Manifest editor dialog over KF.codeEditor. onSubmit receives the raw
 * YAML text and may throw/reject — the error renders inline and the
 * dialog stays open for another attempt. */
KF.yamlEditDialog = function ({ title, initial = "", submitText, onSubmit }) {
  submitText = submitText || KF.t("common.apply");
  return new Promise((resolve) => {
    const overlay = KF.el("div", { class: "kf-overlay" });
    const errorBox = KF.el("pre", {
      class: "kf-yaml-error",
      style: { color: "#c5221f", whiteSpace: "pre-wrap", display: "none" },
    });
    const editor = KF.codeEditor(initial, { textareaClass: "kf-yaml-editor" });
    const textarea = editor.textarea;
    const titleId = "kf-dialog-title-" + ++KF._dialogIds;
    const token = {};
    const opener = document.activeElement || null;
    let pending = false;
    function close(result) {
      if (pending) return; // no cancel while the submit is in flight
      overlay.remove();
      document.removeEventListener("keydown", onKey);
      KF._popModal(token);
      if (opener && opener.focus) opener.focus();
      resolve(result);
    }
    function onKey(ev) {
      if (!KF._isTopModal(token)) return;
      if (ev.key === "Escape") close(false);
      else KF._trapTab(panel, ev);
    }
    async function submit() {
      if (pending) return; // double-click guard while onSubmit is in flight
      pending = true;
      submitBtn.disabled = true;
      try {
        await onSubmit(textarea.value);
        pending = false;
        close(true);
      } catch (err) {
        errorBox.textContent = String((err && err.message) || err);
        errorBox.style.display = "block";
      } finally {
        pending = false;
        submitBtn.disabled = false;
      }
    }
    document.addEventListener("keydown", onKey);
    KF._modalStack.push(token);
    const submitBtn = KF.el(
      "button", { class: "primary", onclick: submit }, submitText
    );
    const panel = KF.el(
      "div",
      { class: "kf-dialog kf-dialog-wide", role: "dialog",
        "aria-modal": "true", "aria-labelledby": titleId },
      KF.el("h3", { id: titleId }, title),
      editor.root,
      errorBox,
      KF.el(
        "div",
        { class: "kf-dialog-actions" },
        KF.el("button", { onclick: () => close(false) },
              KF.t("common.cancel")),
        submitBtn
      )
    );
    overlay.append(panel);
    overlay.addEventListener("click", (ev) => {
      if (ev.target === overlay) close(false);
    });
    document.body.append(overlay);
    textarea.focus();
  });
};

/* ---------------- snackbar (lib/snack-bar) ------------------------------ */

KF.snackbar = function (message, kind = "info") {
  let host = document.getElementById("kf-snackbar-host");
  if (!host) {
    host = KF.el("div", { id: "kf-snackbar-host" });
    document.body.append(host);
  }
  /* a11y: polite live region for info, assertive alert for errors —
   * screen readers announce the toast without focus moving. */
  const bar = KF.el(
    "div",
    kind === "error"
      ? { class: "kf-snackbar " + kind, role: "alert" }
      : { class: "kf-snackbar " + kind, role: "status",
          "aria-live": "polite" },
    message
  );
  host.append(bar);
  setTimeout(() => bar.classList.add("visible"), 10);
  setTimeout(() => {
    bar.classList.remove("visible");
    setTimeout(() => bar.remove(), 300);
  }, 4000);
};

KF.showError = function (err) {
  const banner = document.getElementById("error-banner");
  const text = String((err && err.message) || err);
  if (!banner) return KF.snackbar(text, "error");
  banner.textContent = text;
  banner.style.display = "block";
  setTimeout(() => (banner.style.display = "none"), 8000);
};

/* ---------------- namespace state (lib/namespace-select) ---------------- */

/* localStorage-backed like the reference's central-dashboard namespace
 * sharing; a `storage` listener keeps iframed sub-apps in sync. */
KF.ns = {
  KEY: "kubeflow.namespace",
  get() {
    return localStorage.getItem(KF.ns.KEY) || "kubeflow-user";
  },
  set(value) {
    localStorage.setItem(KF.ns.KEY, value);
  },
  onChange(fn) {
    window.addEventListener("storage", (ev) => {
      if (ev.key === KF.ns.KEY) fn(ev.newValue);
    });
  },
};

KF.namespacePicker = function (onChange) {
  const input = KF.el("input", {
    value: KF.ns.get(),
    style: { width: "180px" },
    list: "kf-ns-options",
  });
  // Datalist fed from the common /api/namespaces route: free text still
  // works (multi-tenant users may lack list-namespace rights).
  if (!document.getElementById("kf-ns-options")) {
    const datalist = KF.el("datalist", { id: "kf-ns-options" });
    document.body.append(datalist);
    KF.api("api/namespaces")
      .then((body) =>
        datalist.replaceChildren(
          ...body.namespaces.map((name) => KF.el("option", { value: name }))
        )
      )
      .catch(() => {});
  }
  input.addEventListener("change", () => {
    KF.ns.set(input.value);
    onChange(input.value);
  });
  KF.ns.onChange((value) => {
    input.value = value;
    onChange(value);
  });
  return input;
};

/* ---------------- form validators (lib/form) ---------------------------- */

KF.validators = {
  /* DNS-1123 label — the reference's resource-name validator. */
  dns1123: (value) =>
    /^[a-z0-9]([-a-z0-9]*[a-z0-9])?$/.test(value) && value.length <= 63
      ? null
      : "Use lowercase letters, digits and dashes (max 63 chars).",
  positiveNumber: (value) =>
    Number(value) > 0 ? null : "Must be a positive number.",
  memoryQuantity: (value) =>
    /^[0-9]+(\.[0-9]+)?(Ei|Pi|Ti|Gi|Mi|Ki|E|P|T|G|M|k)?$/.test(value)
      ? null
      : "Use a Kubernetes quantity, e.g. 1.5Gi.",
};

/* Attach a validator to an input: red border + title on invalid. Returns
 * () => boolean for submit-time checks. */
KF.validate = function (input, validator) {
  function check() {
    const err = validator(input.value);
    input.classList.toggle("invalid", !!err);
    input.title = err || "";
    /* a11y: announce validity to assistive tech, not only via color. */
    if (err) input.setAttribute("aria-invalid", "true");
    else input.removeAttribute("aria-invalid");
    return !err;
  }
  input.addEventListener("input", check);
  return check;
};

/* ---------------- tabs ------------------------------------------------- */

/* tabs: [{label, render(pane) (may return cleanup.stop)}]
 * a11y: the WAI-ARIA tabs pattern — tablist/tab/tabpanel roles,
 * aria-selected state, Arrow-key roving between tabs. */
KF.tabs = function (container, tabs) {
  const bar = KF.el("div", { class: "kf-tabs", role: "tablist" });
  const pane = KF.el("div", { class: "kf-tab-pane", role: "tabpanel" });
  let cleanup = null;
  function select(idx) {
    if (cleanup && cleanup.stop) cleanup.stop();
    cleanup = null;
    [...bar.children].forEach((b, i) => {
      b.classList.toggle("active", i === idx);
      b.setAttribute("aria-selected", i === idx ? "true" : "false");
      b.setAttribute("tabindex", i === idx ? "0" : "-1");
    });
    pane.replaceChildren();
    cleanup = tabs[idx].render(pane) || null;
  }
  tabs.forEach((tab, idx) =>
    bar.append(
      KF.el(
        "button",
        {
          class: "kf-tab",
          role: "tab",
          onclick: () => select(idx),
          onkeydown: (ev) => {
            const delta = ev.key === "ArrowRight" ? 1
              : ev.key === "ArrowLeft" ? -1 : 0;
            if (!delta) return;
            ev.preventDefault();
            const next = (idx + delta + tabs.length) % tabs.length;
            select(next);
            bar.children[next].focus();
          },
        },
        tab.label
      )
    )
  );
  container.replaceChildren(bar, pane);
  select(0);
  return {
    stop() {
      if (cleanup && cleanup.stop) cleanup.stop();
    },
  };
};

/* ---------------- YAML view (lib/editor, read-only) --------------------- */

KF.toYaml = function (value, indent = 0) {
  const pad = "  ".repeat(indent);
  if (value === null || value === undefined) return "null";
  if (typeof value !== "object") {
    const s = String(value);
    return typeof value === "string" &&
      (s === "" || /[:#{}\[\],&*>|%@`"']|^\s|\s$|^[\d.-]/.test(s))
      ? JSON.stringify(s)
      : s;
  }
  if (Array.isArray(value)) {
    if (!value.length) return "[]";
    return value
      .map((item) => {
        if (item !== null && typeof item === "object") {
          const body = KF.toYaml(item, indent + 1);
          return pad + "-\n" + body;
        }
        return pad + "- " + KF.toYaml(item, 0);
      })
      .join("\n");
  }
  const keys = Object.keys(value);
  if (!keys.length) return "{}";
  return keys
    .map((k) => {
      const v = value[k];
      if (v !== null && typeof v === "object" && Object.keys(v).length) {
        return pad + k + ":\n" + KF.toYaml(v, indent + 1);
      }
      return pad + k + ": " + KF.toYaml(v, 0);
    })
    .join("\n");
};

KF.yamlView = function (container, obj) {
  container.replaceChildren(KF.el("pre", { class: "yaml" }, KF.toYaml(obj)));
};

/* ---------------- details drawer --------------------------------------- */

/* Slide-in panel hosting a details page (the reference's per-resource
 * details route, drawer-style so the table stays live behind it). */
KF.drawer = function (title) {
  const content = KF.el("div", { class: "kf-drawer-content" });
  let onClose = null;
  const overlay = KF.el("div", { class: "kf-overlay kf-drawer-overlay" });
  /* a11y: full modal-dialog focus management — focus moves INTO the
   * drawer on open (aria-modal declares the page behind it inert, so
   * leaving focus on the opening row would strand assistive tech) and
   * returns to the opener on close. */
  const opener = document.activeElement || null;
  function onDrawerKey(ev) {
    if (ev.key === "Escape") close();
    else KF._trapTab(panel, ev);
  }
  function close() {
    document.removeEventListener("keydown", onDrawerKey);
    overlay.remove();
    if (opener && opener.focus) opener.focus();
    if (onClose) onClose();
  }
  document.addEventListener("keydown", onDrawerKey);
  const closeBtn = KF.el(
    "button", { onclick: close, "aria-label": "close" }, "✕");
  const panel = KF.el(
    "div",
    { class: "kf-drawer", role: "dialog", "aria-modal": "true",
      "aria-label": String(title) },
    KF.el(
      "div",
      { class: "kf-drawer-head" },
      KF.titleActionsToolbar({ title, actions: [closeBtn] })
    ),
    content
  );
  overlay.addEventListener("click", (ev) => {
    if (ev.target === overlay) close();
  });
  overlay.append(panel);
  document.body.append(overlay);
  closeBtn.focus();
  return {
    content,
    close,
    set onclose(fn) {
      onClose = fn;
    },
  };
};

/* ---------------- GPU slice rollup -------------------------------------- */

/* The panel the reference never needed: worker-by-worker slice health.
 * gpu: spec.gpu {accelerator, topology}; gpuStatus: status.gpu
 * {hosts, readyHosts, chips}; pods: [{name, ready}] worker pod list. */
KF.sliceRollup = function (container, gpu, gpuStatus, pods, opts = {}) {
  if (!gpu) {
    container.replaceChildren(
      KF.el("p", { class: "muted" }, "CPU-only notebook (no GPU slice).")
    );
    return;
  }
  const hosts = (gpuStatus && gpuStatus.hosts) || 1;
  const ready = (gpuStatus && gpuStatus.readyHosts) || 0;
  const chips = (gpuStatus && gpuStatus.chips) || "?";
  const banners = [];
  if (gpuStatus && gpuStatus.capacityPending) {
    banners.push(
      KF.el(
        "p",
        { class: "kf-capacity-banner" },
        "⏳ Waiting for GPU capacity — a queued ProvisioningRequest is ",
        "reserving all " + hosts + " host(s); workers start when it is ",
        "provisioned."
      )
    );
  }
  if (opts.maintenancePending) {
    banners.push(
      KF.el(
        "p",
        { class: "kf-maintenance-banner" },
        "⚠ Node maintenance pending on " + opts.maintenancePending +
          " — checkpoint your work; the slice restarts when the node(s) " +
          "go down."
      )
    );
  }
  const workers = KF.el(
    "div",
    { class: "slice-grid" },
    Array.from({ length: hosts }, (_, i) => {
      const pod = (pods || []).find((p) => p.name && p.name.endsWith("-" + i));
      const phase = pod ? (pod.ready ? "ready" : "waiting") : "stopped";
      return KF.el(
        "div",
        { class: "slice-worker " + phase, title: pod ? pod.name : "no pod" },
        KF.el("span", { class: "dot " + phase, "aria-hidden": "true" }),
        "worker-" + i
      );
    })
  );
  container.replaceChildren(
    ...banners,
    KF.detailsList([
      ["Accelerator", gpu.accelerator],
      ["Topology", gpu.topology],
      ["Slices", gpu.numSlices > 1 ? String(gpu.numSlices) : null],
      ["GPUs", String(chips)],
      ["Hosts ready", ready + " / " + hosts],
    ]),
    workers
  );
};

/* ---------------- help popover (lib/help-popover) ----------------------- */

/* A "?" affordance that toggles an inline popover. Click anywhere else
 * (or Escape) closes it; only one popover is open at a time. One pair of
 * module-level document listeners serves every instance — per-instance
 * registration would leak a listener (and pin its detached popover) for
 * each re-render. */
KF.closeAllPopovers = function () {
  document
    .querySelectorAll(".kf-popover")
    .forEach((p) => (p.style.display = "none"));
};
document.addEventListener("click", KF.closeAllPopovers);
document.addEventListener("keydown", (ev) => {
  if (ev.key === "Escape") KF.closeAllPopovers();
});

KF.helpPopover = function (text) {
  const pop = KF.el("span", { class: "kf-popover", role: "tooltip" }, text);
  pop.style.display = "none";
  const icon = KF.el(
    "button",
    {
      class: "kf-help",
      "aria-label": "help",
      onclick: (ev) => {
        ev.stopPropagation();
        const open = pop.style.display !== "none";
        KF.closeAllPopovers();
        pop.style.display = open ? "none" : "inline-block";
      },
    },
    "?"
  );
  return KF.el("span", { class: "kf-help-slot" }, icon, pop);
};

/* ---------------- loading spinner (lib/loading-spinner) ----------------- */

KF.spinner = function (label) {
  return KF.el(
    "span",
    { class: "kf-spinner", role: "status" },
    KF.el("span", { class: "kf-spinner-dot" }),
    label || KF.t("common.loading")
  );
};

/* Swap a container to a spinner until the promise settles; renders the
 * resolved value through `render(container, value)` or the error through
 * KF.showError. Returns the promise for chaining. */
KF.withSpinner = function (container, promise, render) {
  container.replaceChildren(KF.spinner());
  return promise.then(
    (value) => {
      container.replaceChildren();
      render(container, value);
      return value;
    },
    (err) => {
      container.replaceChildren(
        KF.el("p", { class: "muted" }, "Failed: " + (err.message || err))
      );
      throw err;
    }
  );
};

/* ---------------- variables groups table (lib/variables-groups-table) --- */

/* Grouped key/value rows with collapsible group headers — the reference's
 * variables-groups-table (env vars grouped by their PodDefault/source).
 * groups: [{name, vars: [{key, value}]}]. */
KF.varsGroupsTable = function (container, groups) {
  container.replaceChildren(
    ...((groups || []).length
      ? groups.map((group) => {
          const body = KF.el(
            "table",
            { class: "kf-vars" },
            KF.el(
              "tbody",
              {},
              group.vars.map((v) =>
                KF.el(
                  "tr",
                  {},
                  KF.el("td", { class: "kf-var-key" }, v.key),
                  KF.el(
                    "td",
                    { class: "kf-var-value" },
                    v.value === undefined || v.value === null ? "—" : v.value
                  )
                )
              )
            )
          );
          const head = KF.el(
            "button",
            {
              class: "kf-vars-group-head",
              onclick: () => {
                const hidden = body.style.display === "none";
                body.style.display = hidden ? "" : "none";
                head.textContent =
                  (hidden ? "▾ " : "▸ ") + group.name +
                  ` (${group.vars.length})`;
              },
            },
            `▾ ${group.name} (${group.vars.length})`
          );
          return KF.el("div", { class: "kf-vars-group" }, head, body);
        })
      : [KF.el("p", { class: "muted" }, "No variables.")])
  );
};

/* ---------------- advanced form section --------------------------------- */

/* Collapsible "Advanced options" wrapper (the reference spawner's
 * advanced panels). Starts collapsed; render(pane) runs once on first
 * expand so hidden controls stay cheap. */
KF.advancedSection = function (title, render) {
  const pane = KF.el("div", { class: "kf-advanced-pane" });
  pane.style.display = "none";
  let rendered = false;
  const toggle = KF.el(
    "button",
    {
      class: "kf-advanced-toggle",
      type: "button",
      onclick: () => {
        const hidden = pane.style.display === "none";
        pane.style.display = hidden ? "block" : "none";
        toggle.textContent = (hidden ? "▾ " : "▸ ") + title;
        if (hidden && !rendered) {
          rendered = true;
          render(pane);
        }
      },
    },
    "▸ " + title
  );
  return KF.el("div", { class: "kf-advanced" }, toggle, pane);
};

/* ---------------- chips input (advanced form control) ------------------- */

/* Free-form list-of-strings input: type + Enter adds a chip, ✕ removes.
 * onChange receives the current list. */
/* opts.validate(value) -> error string | null rejects bad entries at
 * Enter time (red border + title) instead of silently dropping them at
 * submit time. */
/* ---------------- volume forms (reference: jupyter form-new/volume) ------
 *
 * Per-volume panel with new-vs-existing choice; "new" edits name
 * (with {notebook-name} templating), size, storage class and access
 * mode; "existing" picks a PVC. value() emits the backend's
 * workspaceVolume/dataVolumes contract (web/jupyter/form.py
 * _apply_volumes): {newPvc: {metadata, spec}, mount} |
 * {existingSource: {persistentVolumeClaim}, mount} | null.
 * Mirrors form-workspace-volume / form-data-volumes / volume/new/*
 * (name, size, storage-class, access-modes sub-components). */

KF.ACCESS_MODES = ["ReadWriteOnce", "ReadWriteMany", "ReadOnlyMany"];

KF.volumePanel = function (opts = {}) {
  const kind = opts.kind || "data"; // "workspace" | "data"
  const catalogs = opts.catalogs || {}; // {pvcs, storageClasses, defaultClass}
  const modes = kind === "workspace"
    ? ["new", "existing", "none"]
    : ["new", "existing"];
  const modeLabels = {
    new: KF.t("volumes.typeNew"),
    existing: KF.t("volumes.typeExisting"),
    none: KF.t("volumes.typeNone"),
  };

  const root = KF.el("div", { class: "kf-volume-panel" });
  const body = KF.el("div", {});
  const modeSelect = KF.el(
    "select",
    { class: "kf-volume-mode", style: { width: "auto" }, onchange: render },
    modes.map((m) => KF.el("option", { value: m }, modeLabels[m]))
  );
  if (opts.mode) modeSelect.value = opts.mode;

  const state = {
    name: opts.name || (kind === "workspace"
      ? "{notebook-name}-workspace"
      : `{notebook-name}-datavol-${opts.index || 1}`),
    sizeGi: opts.sizeGi || (kind === "workspace" ? "10" : "5"),
    storageClass: "",         // "" = cluster default
    accessMode: "ReadWriteOnce",
    existing: "",
    mount: opts.mount || (kind === "workspace"
      ? "/home/jovyan"
      : `/home/jovyan/data-${opts.index || 1}`),
  };

  function field(labelKey, control) {
    return KF.el(
      "label",
      { class: "kf-volume-field",
        style: { display: "block", margin: "6px 0" } },
      KF.el("span", { style: { display: "inline-block", minWidth: "110px" } },
            KF.t(labelKey)),
      control
    );
  }

  function bound(attrs, key, tag = "input") {
    const node = KF.el(tag, Object.assign({
      value: state[key],
      oninput: (ev) => { state[key] = ev.target.value; },
      onchange: (ev) => { state[key] = ev.target.value; },
    }, attrs));
    if (tag === "input") node.value = state[key];
    return node;
  }

  function render() {
    const mode = modeSelect.value;
    if (mode === "none") {
      body.replaceChildren(
        KF.el("p", { class: "muted" }, KF.t("volumes.noneHint")));
      return;
    }
    if (mode === "existing") {
      const pvcs = catalogs.pvcs || [];
      const pick = KF.el(
        "select",
        { class: "kf-volume-existing", style: { width: "auto" },
          onchange: (ev) => { state.existing = ev.target.value; } },
        pvcs.length
          ? pvcs.map((p) => KF.el(
              "option", { value: p.name },
              `${p.name} (${p.capacity || "?"})`))
          : [KF.el("option", { value: "" }, KF.t("volumes.noPvcs"))]
      );
      if (pvcs.length && !state.existing) state.existing = pvcs[0].name;
      if (state.existing) pick.value = state.existing;
      body.replaceChildren(
        field("volumes.existingPvc", pick),
        field("volumes.mount", bound({ class: "kf-volume-mount" }, "mount"))
      );
      return;
    }
    const classes = catalogs.storageClasses || [];
    const classSelect = KF.el(
      "select",
      { class: "kf-volume-class", style: { width: "auto" },
        onchange: (ev) => { state.storageClass = ev.target.value; } },
      KF.el("option", { value: "" },
            KF.t("volumes.defaultClass",
                 { name: catalogs.defaultClass || "—" })),
      classes.map((c) => KF.el("option", { value: c }, c))
    );
    if (state.storageClass) classSelect.value = state.storageClass;
    const modeSel = KF.el(
      "select",
      { class: "kf-volume-access", style: { width: "auto" },
        onchange: (ev) => { state.accessMode = ev.target.value; } },
      KF.ACCESS_MODES.map((m) => KF.el("option", { value: m }, m))
    );
    modeSel.value = state.accessMode;
    body.replaceChildren(
      field("volumes.name", bound({ class: "kf-volume-name" }, "name")),
      field("volumes.size", KF.el(
        "span", {},
        bound({ class: "kf-volume-size", type: "number", min: "1",
                style: { width: "70px" } }, "sizeGi"),
        " Gi")),
      field("volumes.class", classSelect),
      field("volumes.accessMode", modeSel),
      field("volumes.mount", bound({ class: "kf-volume-mount" }, "mount"))
    );
  }

  render();
  root.append(modeSelect, body);
  return {
    root,
    get mode() {
      return modeSelect.value;
    },
    value() {
      const mode = modeSelect.value;
      if (mode === "none") return null;
      if (mode === "existing") {
        if (!state.existing) return null;
        return {
          existingSource: {
            persistentVolumeClaim: { claimName: state.existing },
          },
          mount: state.mount,
        };
      }
      // A cleared number input yields "" — fall back to the panel's
      // default rather than emitting the invalid quantity "Gi" (the
      // apiserver rejects it with an opaque parse error).
      const size = parseInt(state.sizeGi, 10);
      const sizeGi = Number.isFinite(size) && size >= 1
        ? size
        : (kind === "workspace" ? 10 : 5);
      const spec = {
        accessModes: [state.accessMode],
        resources: { requests: { storage: `${sizeGi}Gi` } },
      };
      if (state.storageClass) spec.storageClassName = state.storageClass;
      return {
        newPvc: { metadata: { name: state.name }, spec },
        mount: state.mount,
      };
    },
  };
};

KF.dataVolumesForm = function (container, catalogs = {}) {
  /* N removable volume panels + the two add buttons (reference
   * form-data-volumes: addNewVolume / attachExistingVolume). */
  const panels = [];
  const list = KF.el("div", {});
  let counter = 0;

  function add(mode) {
    counter += 1;
    const panel = KF.volumePanel({
      kind: "data", index: counter, mode, catalogs,
    });
    const row = KF.el(
      "div",
      { class: "kf-data-volume", style: { margin: "6px 0" } },
      panel.root,
      KF.actionButton(KF.t("action.delete"), () => {
        const at = panels.indexOf(panel);
        if (at >= 0) panels.splice(at, 1);
        row.remove();
      }, { class: "danger" })
    );
    panels.push(panel);
    list.append(row);
  }

  container.replaceChildren(
    list,
    KF.el("div", { style: { marginTop: "4px" } },
      KF.actionButton(KF.t("volumes.addNew"), () => add("new")),
      " ",
      KF.actionButton(KF.t("volumes.attachExisting"), () => add("existing"))
    )
  );
  return {
    add,
    value() {
      return panels.map((p) => p.value()).filter(Boolean);
    },
  };
};

KF.registerMessages("en", {
  "volumes.typeNew": "New volume",
  "volumes.typeExisting": "Existing volume",
  "volumes.typeNone": "No volume",
  "volumes.noneHint": "The server runs on ephemeral storage only.",
  "volumes.name": "Name",
  "volumes.size": "Size",
  "volumes.class": "Storage class",
  "volumes.defaultClass": "cluster default ({name})",
  "volumes.accessMode": "Access mode",
  "volumes.mount": "Mount path",
  "volumes.existingPvc": "PVC",
  "volumes.noPvcs": "no PVCs in this namespace",
  "volumes.addNew": "+ Add new volume",
  "volumes.attachExisting": "+ Attach existing volume",
});
KF.registerMessages("de", {
  "volumes.typeNew": "Neues Volume",
  "volumes.typeExisting": "Vorhandenes Volume",
  "volumes.typeNone": "Kein Volume",
  "volumes.noneHint": "Der Server läuft nur mit flüchtigem Speicher.",
  "volumes.name": "Name",
  "volumes.size": "Größe",
  "volumes.class": "Speicherklasse",
  "volumes.defaultClass": "Cluster-Standard ({name})",
  "volumes.accessMode": "Zugriffsmodus",
  "volumes.mount": "Mount-Pfad",
  "volumes.existingPvc": "PVC",
  "volumes.noPvcs": "keine PVCs in diesem Namespace",
  "volumes.addNew": "+ Neues Volume",
  "volumes.attachExisting": "+ Vorhandenes Volume anhängen",
});
KF.registerMessages("fr", {
  "volumes.typeNew": "Nouveau volume",
  "volumes.typeExisting": "Volume existant",
  "volumes.typeNone": "Aucun volume",
  "volumes.noneHint": "Le serveur utilise uniquement un stockage éphémère.",
  "volumes.name": "Nom",
  "volumes.size": "Taille",
  "volumes.class": "Classe de stockage",
  "volumes.defaultClass": "défaut du cluster ({name})",
  "volumes.accessMode": "Mode d'accès",
  "volumes.mount": "Chemin de montage",
  "volumes.existingPvc": "PVC",
  "volumes.noPvcs": "aucun PVC dans ce namespace",
  "volumes.addNew": "+ Ajouter un volume",
  "volumes.attachExisting": "+ Attacher un volume existant",
});

KF.chipsInput = function (initial, onChange, { placeholder, validate } = {}) {
  const values = (initial || []).slice();
  const list = KF.el("span", { class: "kf-chips" });
  function renderChips() {
    list.replaceChildren(
      ...values.map((value, idx) =>
        KF.el(
          "span",
          { class: "chip" },
          value,
          KF.el(
            "button",
            {
              type: "button",
              class: "kf-chip-x",
              onclick: () => {
                values.splice(idx, 1);
                renderChips();
                onChange(values.slice());
              },
            },
            "✕"
          )
        )
      )
    );
  }
  const input = KF.el("input", {
    placeholder: placeholder || KF.t("common.chipPlaceholder"),
    style: { width: "200px" },
  });
  input.addEventListener("keydown", (ev) => {
    if (ev.key !== "Enter") return;
    ev.preventDefault();
    const value = (input.value || "").trim();
    if (!value || values.includes(value)) return;
    const err = validate ? validate(value) : null;
    input.classList.toggle("invalid", !!err);
    input.title = err || "";
    if (err) return;
    values.push(value);
    input.value = "";
    renderChips();
    onChange(values.slice());
  });
  renderChips();
  return KF.el("span", { class: "kf-chips-input" }, list, input);
};

/* ---------------- title-actions toolbar (lib/title-actions-toolbar) ----- */

/* Page/drawer header row: back affordance, title + subtitle on the left,
 * action buttons on the right — the reference's title-actions-toolbar. */
KF.titleActionsToolbar = function ({ title, subtitle, actions, onBack }) {
  return KF.el(
    "div",
    { class: "kf-toolbar" },
    onBack
      ? KF.el(
          "button",
          { class: "kf-toolbar-back", "aria-label": "back", onclick: onBack },
          "←"
        )
      : null,
    KF.el(
      "div",
      { class: "kf-toolbar-titles" },
      KF.el("h2", {}, title),
      subtitle ? KF.el("span", { class: "muted" }, subtitle) : null
    ),
    KF.el("div", { class: "kf-toolbar-actions" }, actions || [])
  );
};

/* ---------------- app URLs (lib/urls) ----------------------------------- */

/* The L7 URL contract in one place — every link the mesh routes
 * (/notebook/<ns>/<name>/, /tensorboard/..., /pvcviewer/...) is built
 * here so the scheme can't drift per app. */
KF.urls = {
  notebook: (ns, name) =>
    "/notebook/" + encodeURIComponent(ns) + "/" + encodeURIComponent(name) + "/",
  tensorboard: (ns, name) =>
    "/tensorboard/" + encodeURIComponent(ns) + "/" + encodeURIComponent(name) + "/",
  pvcviewer: (ns, name) =>
    "/pvcviewer/" + encodeURIComponent(ns) + "/" + encodeURIComponent(name) + "/",
};

/* ---------------- sparkline (dashboard metrics) ------------------------- */

/* Dependency-free time-series mini chart; points: [{timestamp, value}]. */
KF.sparkline = function (canvas, points, { stroke = "#1a73e8" } = {}) {
  const ctx = canvas.getContext("2d");
  const w = (canvas.width = canvas.clientWidth * 2 || 600);
  const h = (canvas.height = canvas.clientHeight * 2 || 120);
  ctx.clearRect(0, 0, w, h);
  if (!points || points.length < 2) {
    ctx.fillStyle = "#5f6368";
    ctx.font = "24px system-ui";
    ctx.fillText("no data", 12, h / 2);
    return;
  }
  const xs = points.map((p) => p.timestamp);
  const ys = points.map((p) => p.value);
  const [x0, x1] = [Math.min(...xs), Math.max(...xs)];
  const [y0, y1] = [Math.min(...ys), Math.max(...ys)];
  const sx = (x) => ((x - x0) / (x1 - x0 || 1)) * (w - 16) + 8;
  const sy = (y) => h - 8 - ((y - y0) / (y1 - y0 || 1)) * (h - 16);
  ctx.beginPath();
  ctx.strokeStyle = stroke;
  ctx.lineWidth = 3;
  points.forEach((p, i) =>
    i
      ? ctx.lineTo(sx(p.timestamp), sy(p.value))
      : ctx.moveTo(sx(p.timestamp), sy(p.value))
  );
  ctx.stroke();
};

/* ---------------- legacy global aliases --------------------------------- */

const getCookie = KF.getCookie;
const api = KF.api;
const el = KF.el;
const statusDot = KF.statusDot;
const renderTable = KF.renderTable;
const ns = KF.ns;
const namespacePicker = KF.namespacePicker;
const showError = KF.showError;
function poll(fn, intervalMs = 4000) {
  return KF.poller(fn, { base: intervalMs });
}
