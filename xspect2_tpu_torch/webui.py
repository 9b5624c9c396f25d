"""The built-in single-page web UI, served at ``/`` by
:mod:`xspect2_tpu_torch.web`.

The JAX package's page (``xspect2_tpu/webui.py``), byte for byte: the
same UI over the same REST API.  A dependency-free single-file
application: classify and filter forms with upload and result polling,
a result view with a total-score bar chart and a per-record score chart,
a model list with per-model detail panels (metadata, editable author
fields, per-filter display names), and deep-linkable hash routes
(``#/classify``, ``#/filter``, ``#/models``, ``#/models/<slug>``,
``#/result/<uuid>``, ``#/filter-result/<uuid>``).
"""

INDEX_HTML = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<title>XspecT2-TPU</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root { --fg:#1a1a1a; --mut:#667; --line:#dde; --acc:#2458e6; --bg:#fff; }
*{box-sizing:border-box} body{font-family:system-ui,sans-serif;color:var(--fg);
 background:var(--bg);max-width:860px;margin:0 auto;padding:1em}
nav{display:flex;gap:.4em;border-bottom:2px solid var(--line);margin-bottom:1.2em}
nav button{border:none;background:none;padding:.7em 1em;font-size:1em;cursor:pointer;
 color:var(--mut);border-bottom:2px solid transparent;margin-bottom:-2px}
nav button.active{color:var(--acc);border-bottom-color:var(--acc);font-weight:600}
h1{font-size:1.3em} .view{display:none}.view.active{display:block}
label{display:block;margin:.8em 0 .2em;font-weight:600;font-size:.9em}
input,select{padding:.45em;border:1px solid var(--line);border-radius:6px;width:100%;max-width:22em}
button.go{margin-top:1em;background:var(--acc);color:#fff;border:none;border-radius:6px;
 padding:.6em 1.4em;font-size:1em;cursor:pointer}
button.sm{background:var(--acc);color:#fff;border:none;border-radius:5px;
 padding:.3em .8em;font-size:.8em;cursor:pointer}
.card{border:1px solid var(--line);border-radius:8px;padding:1em;margin:.8em 0}
.bar{height:14px;background:var(--acc);border-radius:3px;min-width:2px}
.row{display:flex;align-items:center;gap:.6em;margin:.25em 0;font-size:.85em}
.row .lbl{width:11em;text-align:right;color:var(--mut);overflow:hidden;text-overflow:ellipsis}
.row .val{width:3.5em}.muted{color:var(--mut);font-size:.85em}
pre{background:#f6f7fa;padding:.8em;border-radius:6px;overflow:auto;font-size:.8em}
.status{margin-top:.8em;font-size:.9em;color:var(--mut)}
table.meta{border-collapse:collapse;font-size:.85em;margin:.5em 0}
table.meta td{border-bottom:1px solid var(--line);padding:.3em .7em .3em 0;vertical-align:top}
table.meta td:first-child{color:var(--mut);white-space:nowrap}
.dn-row{display:flex;gap:.5em;align-items:center;margin:.2em 0;font-size:.85em}
.dn-row input{max-width:14em;padding:.25em}
.detail{display:none;margin-top:.8em;border-top:1px dashed var(--line);padding-top:.6em}
.card.open .detail{display:block}
a.slug{cursor:pointer;color:var(--acc);text-decoration:underline;font-size:.85em}
</style></head><body>
<h1>XspecT2-TPU <span class="muted">taxonomic classification</span></h1>
<nav>
 <button data-v="classify" class="active">Classify</button>
 <button data-v="filter">Filter</button>
 <button data-v="models">Models</button>
</nav>

<div id="classify" class="view active">
 <label>Sample file (FASTA/FASTQ)</label><input type="file" id="cFile">
 <label>Type</label><select id="cType"><option>Species</option><option>Genus</option></select>
 <label>Model</label><select id="cModel"></select>
 <label>Sparse sampling step</label><input type="number" id="cStep" value="1" min="1">
 <button class="go" onclick="runClassify()">Classify</button>
 <div class="status" id="cStatus"></div>
 <div id="cResult"></div>
</div>

<div id="filter" class="view">
 <label>Sample file (FASTA/FASTQ)</label><input type="file" id="fFile">
 <label>Type</label><select id="fType"><option>Genus</option><option>Species</option></select>
 <label>Genus model</label><select id="fModel"></select>
 <label>Species id (species filtering only)</label><input id="fSpecies" placeholder="e.g. 470">
 <label>Threshold (-1 = argmax)</label><input type="number" id="fThr" value="0.7" step="0.1">
 <button class="go" onclick="runFilter()">Filter</button>
 <div class="status" id="fStatus"></div>
 <div id="fResult"></div>
</div>

<div id="models" class="view">
 <div id="mList" class="muted">loading…</div>
</div>

<script>
const $ = (id) => document.getElementById(id);
const api = (p) => fetch(p).then(r => r.json());
const esc = (s) => String(s).replace(/[&<>"']/g, c =>
  ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));

// hash router (the reference SPA's routes, App.tsx:14-27):
// #/classify #/filter #/models #/models/<slug> #/result/<uuid>
// #/filter-result/<uuid> — deep-linkable, survives reload
function showView(v) {
  document.querySelectorAll('nav button').forEach(x =>
    x.classList.toggle('active', x.dataset.v === v));
  document.querySelectorAll('.view').forEach(x =>
    x.classList.toggle('active', x.id === v));
}
document.querySelectorAll('nav button').forEach(b => b.onclick = () => {
  location.hash = '#/' + b.dataset.v;
});

async function route() {
  const parts = location.hash.replace(/^#\\/?/, '').split('/');
  const page = parts[0] || 'classify';
  if (page === 'result' && parts[1]) {
    showView('classify');
    pollClassifyResult(parts[1]);
  } else if (page === 'filter-result' && parts[1]) {
    showView('filter');
    pollFilterResult(parts[1]);
  } else if (page === 'models' && parts[1]) {
    showView('models');
    await MODELS_READY;
    const card = $('card-' + parts[1]);
    if (card) {
      if (!card.classList.contains('open')) {
        card.classList.add('open');
        await renderDetail(parts[1]);
      }
      card.scrollIntoView();
    }
  } else if (['classify', 'filter', 'models'].includes(page)) {
    showView(page);
  } else {
    showView('classify');
  }
}
window.addEventListener('hashchange', route);

let MODELS = {};
const slugOf = (n, type) =>
  n.toLowerCase().replace(/[^a-z0-9]+/g, '-') + '-' + type.toLowerCase();

async function loadModels() {
  MODELS = await api('/api/list-models');
  const opts = (t) => (MODELS[t] || []).map(m => `<option>${esc(m)}</option>`).join('');
  $('cModel').innerHTML = opts($('cType').value);
  $('fModel').innerHTML = opts('Species');
  let html = '';
  for (const [type, names] of Object.entries(MODELS)) {
    for (const n of names) {
      const slug = slugOf(n, type);
      html += `<div class="card" id="card-${slug}"><b>${esc(n)}</b>
        <span class="muted">(${esc(type)})</span>
        <a class="slug" href="#/models/${slug}">details</a>
        <div class="detail" id="detail-${slug}">loading…</div></div>`;
    }
  }
  $('mList').innerHTML = html || 'No models found — train one with the CLI.';
}
$('cType').onchange = () => {
  $('cModel').innerHTML = (MODELS[$('cType').value] || []).map(m => `<option>${esc(m)}</option>`).join('');
};
// route() must run even when the model list fails to load: a deep
// link like #/result/<uuid> only needs the result endpoint
const MODELS_READY = loadModels().catch(() => {
  $('mList').textContent = 'Failed to load models.';
});
MODELS_READY.then(route);

// ------------------------------------------------------------ model detail
// the reference's /models/:slug page: formatted metadata + editing
const META_FIELDS = ['model_slug','model_class','model_type','k','fpr',
                     'num_hashes','kernel','C','organism','loci'];

async function renderDetail(slug) {
  const d = await api('/api/model-metadata?model_slug=' + slug);
  let rows = '';
  for (const f of META_FIELDS) {
    if (d[f] !== undefined && d[f] !== null)
      rows += `<tr><td>${f}</td><td>${esc(JSON.stringify(d[f]))}</td></tr>`;
  }
  // interactive elements use data-attributes + a delegated listener:
  // interpolating untrusted values (display-name filter ids, metadata
  // strings) into inline onclick JS would re-open them as code after
  // the HTML parser decodes esc()'s entity escapes
  rows += `<tr><td>author</td><td>
      <input class="auth-name" value="${esc(d.author ?? '')}">
      <input class="auth-mail" value="${esc(d.author_email ?? '')}" placeholder="email">
      <button class="sm" data-act="save-author" data-slug="${slug}">save</button></td></tr>`;
  let dns = '';
  for (const [fid, name] of Object.entries(d.display_names || {})) {
    dns += `<div class="dn-row"><span class="muted">${esc(fid)}</span>
      <input class="dn-input" value="${esc(name)}">
      <button class="sm" data-act="rename" data-slug="${slug}" data-fid="${esc(fid)}">rename</button></div>`;
  }
  $('detail-' + slug).innerHTML = `<table class="meta">${rows}</table>
    ${dns ? '<b style="font-size:.85em">Display names</b>' + dns : ''}
    <details><summary class="muted">raw metadata</summary>
    <pre>${esc(JSON.stringify(d, null, 1))}</pre></details>
    <div class="status" id="dstat-${slug}"></div>`;
}

async function saveAuthor(slug, btn) {
  const td = btn.closest('td');
  const q = `model_slug=${slug}` +
            `&author=${encodeURIComponent(td.querySelector('.auth-name').value)}` +
            `&author_email=${encodeURIComponent(td.querySelector('.auth-mail').value)}`;
  const r = await fetch('/api/model-metadata?' + q, {method:'POST'});
  $('dstat-'+slug).textContent = r.ok ? 'Saved.' : 'Error saving metadata.';
}

async function saveDisplayName(slug, fid, btn) {
  const value = btn.closest('.dn-row').querySelector('.dn-input').value;
  const q = `model_slug=${slug}&filter_id=${encodeURIComponent(fid)}` +
            `&display_name=${encodeURIComponent(value)}`;
  const r = await fetch('/api/model-display-name?' + q, {method:'POST'});
  $('dstat-'+slug).textContent = r.ok ? 'Renamed.' : 'Error renaming.';
  if (r.ok) renderDetail(slug);
}

document.addEventListener('click', (e) => {
  const b = e.target.closest('[data-act]');
  if (!b) return;
  if (b.dataset.act === 'save-author') saveAuthor(b.dataset.slug, b);
  else if (b.dataset.act === 'rename') saveDisplayName(b.dataset.slug, b.dataset.fid, b);
});

// ------------------------------------------------------------ upload + bars

async function upload(fileInput, statusEl) {
  const f = fileInput.files[0];
  if (!f) { statusEl.textContent = 'Choose a file first.'; return null; }
  statusEl.textContent = 'Uploading…';
  const fd = new FormData(); fd.append('file', f);
  const r = await fetch('/api/upload-file', { method: 'POST', body: fd }).then(r => r.json());
  return r.filename;
}

function scoreBars(scores) {
  const entries = Object.entries(scores).sort((a, b) => b[1] - a[1]).slice(0, 15);
  return entries.map(([k, v]) =>
    `<div class="row"><div class="lbl">${esc(k)}</div>
     <div class="bar" style="width:${Math.max(2, v * 300)}px"></div>
     <div class="val">${v.toFixed(2)}</div></div>`).join('');
}

// per-record score chart (the reference's result-chart.tsx): a record
// selector re-renders the bar chart for that record's score vector
let LAST_RESULT = null;
function recordChart() {
  const rec = $('recSel').value;
  $('recChart').innerHTML = scoreBars(LAST_RESULT.scores[rec] || {});
}

// polling loops are keyed by uuid so the hashchange fired by our own
// submit doesn't start a second loop for the same job
const ACTIVE_POLLS = new Set();

async function runClassify() {
  const fname = await upload($('cFile'), $('cStatus')); if (!fname) return;
  $('cStatus').textContent = 'Classifying…';
  const q = `classification_type=${$('cType').value}&model=${encodeURIComponent($('cModel').value)}` +
            `&file=${encodeURIComponent(fname)}&step=${$('cStep').value}`;
  const { uuid } = await fetch('/api/classify?' + q, { method: 'POST' }).then(r => r.json());
  location.hash = '#/result/' + uuid;  // deep link; route() starts the poll
}

async function pollClassifyResult(uuid) {
  if (ACTIVE_POLLS.has(uuid)) return;
  ACTIVE_POLLS.add(uuid);
  try {
    $('cStatus').textContent = 'Waiting for result ' + uuid + '…';
    for (let i = 0; i < 120; i++) {
      const r = await fetch('/api/classification-result?uuid=' + encodeURIComponent(uuid));
      if (r.status === 200) {
        const d = await r.json();
        LAST_RESULT = d;
        const records = Object.keys(d.scores).filter(k => k !== 'total');
        $('cStatus').textContent = 'Done.';
        $('cResult').innerHTML = `<div class="card">
          ${d.prediction !== undefined ? `<b>Prediction: ${esc(d.prediction)}</b>` : ''}
          <div class="muted">${esc(d.input_source || '')} · model ${esc(d.model_slug)}</div>
          <h3 style="font-size:.9em">Total scores</h3>${scoreBars(d.scores.total)}
          <h3 style="font-size:.9em">Per-record scores
            <select id="recSel" style="max-width:14em" onchange="recordChart()">
              ${records.map(r => `<option>${esc(r)}</option>`).join('')}
            </select></h3>
          <div id="recChart"></div>
          <details><summary class="muted">raw result</summary><pre>${esc(JSON.stringify(d, null, 1))}</pre></details>
        </div>`;
        if (records.length) recordChart();
        return;
      }
      await new Promise(res => setTimeout(res, 1000));
    }
    $('cStatus').textContent = 'Timed out waiting for result.';
  } finally {
    ACTIVE_POLLS.delete(uuid);
  }
}

async function runFilter() {
  const fname = await upload($('fFile'), $('fStatus')); if (!fname) return;
  $('fStatus').textContent = 'Filtering…';
  let q = `filter_type=${$('fType').value}&genus=${encodeURIComponent($('fModel').value)}` +
          `&input_file=${encodeURIComponent(fname)}&threshold=${$('fThr').value}`;
  if ($('fType').value === 'Species') q += `&filter_species=${encodeURIComponent($('fSpecies').value)}`;
  const { uuid } = await fetch('/api/filter?' + q, { method: 'POST' }).then(r => r.json());
  location.hash = '#/filter-result/' + uuid;  // deep link; route() polls
}

async function pollFilterResult(uuid) {
  if (ACTIVE_POLLS.has(uuid)) return;
  ACTIVE_POLLS.add(uuid);
  try {
    $('fStatus').textContent = 'Waiting for result ' + uuid + '…';
    for (let i = 0; i < 120; i++) {
      const r = await fetch('/api/filtering-result?uuid=' + encodeURIComponent(uuid));
      if (r.status === 200) {
        const d = await r.json();
        $('fStatus').textContent = d.message;
        // the filter job records its underlying classification under
        // the same uuid: render the score chart next to the download
        // (the reference SPA's filter-result view)
        let scores = '';
        const cr = await fetch('/api/classification-result?uuid=' + encodeURIComponent(uuid));
        if (cr.status === 200) {
          const c = await cr.json();
          if (c.scores && c.scores.total)
            scores = `<h3 style="font-size:.9em">Filter scores (total)</h3>${scoreBars(c.scores.total)}`;
        }
        const dl = (d.message || '').includes('successfully')
          ? `<a href="/api/download-filtered?uuid=${encodeURIComponent(uuid)}">Download filtered FASTA</a>`
          : '';
        if (dl || scores)
          $('fResult').innerHTML = `<div class="card">${dl}${scores}</div>`;
        return;
      }
      await new Promise(res => setTimeout(res, 1000));
    }
    $('fStatus').textContent = 'Timed out waiting for result.';
  } finally {
    ACTIVE_POLLS.delete(uuid);
  }
}
</script></body></html>
"""
