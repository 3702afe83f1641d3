"""Built-in chat web UI (role of the reference's tools/server/webui).

A single self-contained page served at GET /. Functional parity with the
reference webui app (tools/server/webui — Svelte chat app with conversation
history, settings, attachments), kept build-step-free: no vendored bundles,
no external assets.

Capabilities:
* streaming chat over /v1/chat/completions SSE, with a Stop button
  (AbortController) and tokens/s stats per reply;
* multiple conversations persisted client-side (localStorage), auto-titled
  from the first user message; rename / delete / export / import (JSON);
* settings dialog: system prompt, temperature, top_k, top_p, min_p,
  max_tokens, repeat/presence/frequency penalties, plus a raw "custom JSON"
  field merged into the request (the reference webui's advanced params);
* markdown rendering of assistant replies (headings, emphasis, lists,
  links, blockquote, hr, tables, fenced code blocks with a copy button);
* per-message actions: copy, regenerate last reply, edit last user turn;
* image attachments sent as OpenAI content parts (the server's mtmd path);
* light/dark follows the system color scheme.

The port's own copy of llamacog_tpu/server/webui.py.
"""

WEBUI_HTML = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>llamacog server</title>
<style>
  :root { color-scheme: light dark;
    --bg: #fff; --fg: #111; --muted: #6668; --line: #8884;
    --accent: #4a6cf7; --bub: #8881; --code: #80808018; }
  @media (prefers-color-scheme: dark) {
    :root { --bg: #191a1d; --fg: #e6e6e6; --bub: #ffffff10; } }
  * { box-sizing: border-box; }
  body { font: 15px/1.5 system-ui, sans-serif; margin: 0; height: 100vh;
         display: flex; background: var(--bg); color: var(--fg); }
  #side { width: 240px; border-right: 1px solid var(--line); display: flex;
          flex-direction: column; min-width: 0; }
  #side.hide { display: none; }
  #side header { padding: .6rem; display: flex; gap: .4rem; }
  #convs { flex: 1; overflow-y: auto; }
  .conv { padding: .45rem .7rem; cursor: pointer; display: flex; gap: .3rem;
          align-items: center; border-left: 3px solid transparent; }
  .conv.cur { background: var(--bub); border-left-color: var(--accent); }
  .conv span { flex: 1; overflow: hidden; text-overflow: ellipsis;
               white-space: nowrap; }
  .conv button { padding: 0 .35rem; opacity: .5; }
  #side footer { padding: .5rem; display: flex; gap: .4rem;
                 border-top: 1px solid var(--line); }
  #main { flex: 1; display: flex; flex-direction: column; min-width: 0; }
  #top { padding: .55rem 1rem; border-bottom: 1px solid var(--line);
         display: flex; gap: .8rem; align-items: center; }
  #top h1 { font-size: 1rem; margin: 0; }
  #model { opacity: .65; font-size: .85rem; flex: 1; overflow: hidden;
           text-overflow: ellipsis; white-space: nowrap; }
  #log { flex: 1; overflow-y: auto; padding: 1rem; }
  .row { max-width: 48rem; margin: 0 auto .9rem; }
  .msg { padding: .6rem .9rem; border-radius: .6rem; overflow-wrap: break-word; }
  .user .msg { background: #4a6cf722; border: 1px solid #4a6cf744;
               white-space: pre-wrap; }
  .assistant .msg { background: var(--bub); }
  .msg img.att { max-width: 180px; max-height: 180px; border-radius: .4rem;
                 display: block; margin: .3rem 0; }
  .acts { font-size: .72rem; opacity: 0; margin-top: .15rem; display: flex;
          gap: .6rem; align-items: center; }
  .row:hover .acts { opacity: .75; }
  .acts button { border: 0; background: none; color: inherit; cursor: pointer;
                 padding: 0; font-size: .72rem; text-decoration: underline; }
  .stats { opacity: .6; }
  .msg pre { background: var(--code); padding: .6rem .8rem; border-radius: .4rem;
             overflow-x: auto; position: relative; }
  .msg pre button.cp { position: absolute; top: .25rem; right: .25rem;
    font-size: .7rem; opacity: .6; }
  .msg code { background: var(--code); padding: .05rem .3rem;
              border-radius: .25rem; font-size: .88em; }
  .msg pre code { background: none; padding: 0; }
  .msg table { border-collapse: collapse; }
  .msg td, .msg th { border: 1px solid var(--line); padding: .2rem .5rem; }
  .msg blockquote { border-left: 3px solid var(--line); margin: .3rem 0;
                    padding-left: .7rem; opacity: .85; }
  form { display: flex; gap: .5rem; padding: .8rem 1rem; align-items: flex-end;
         border-top: 1px solid var(--line); }
  textarea { flex: 1; resize: none; font: inherit; padding: .5rem;
             border-radius: .5rem; border: 1px solid var(--line);
             background: inherit; color: inherit; max-height: 10rem; }
  button { font: inherit; padding: .4rem .9rem; border-radius: .5rem;
           border: 1px solid var(--line); cursor: pointer;
           background: var(--bub); color: inherit; }
  button.primary { background: var(--accent); color: #fff; border: 0; }
  #stop { display: none; }
  #attbar { display: flex; gap: .4rem; padding: 0 1rem; }
  #attbar img { max-height: 56px; border-radius: .3rem; }
  dialog { border: 1px solid var(--line); border-radius: .6rem; padding: 1rem;
           background: var(--bg); color: var(--fg); width: min(34rem, 92vw); }
  dialog h2 { margin: 0 0 .6rem; font-size: 1rem; }
  dialog label { display: flex; justify-content: space-between; gap: .6rem;
                 margin: .35rem 0; font-size: .85rem; align-items: center; }
  dialog input[type=number] { width: 6rem; }
  dialog textarea, dialog input[type=text] { width: 100%; font: inherit;
    background: inherit; color: inherit; border: 1px solid var(--line);
    border-radius: .35rem; padding: .3rem; }
  dialog .cols { display: grid; grid-template-columns: 1fr 1fr; gap: 0 1.2rem; }
  dialog footer { margin-top: .8rem; display: flex; gap: .5rem;
                  justify-content: flex-end; }
</style>
</head>
<body>
<aside id="side">
  <header>
    <button id="newc" class="primary" style="flex:1">+ New chat</button>
  </header>
  <div id="convs"></div>
  <footer>
    <button id="exp" title="download all conversations as JSON">export</button>
    <button id="imp" title="import conversations JSON">import</button>
    <input id="impfile" type="file" accept="application/json" hidden>
  </footer>
</aside>
<main id="main">
  <div id="top">
    <button id="burger" title="toggle sidebar">&#9776;</button>
    <h1>llamacog</h1>
    <span id="model"></span>
    <button id="cfg" title="settings">&#9881;</button>
  </div>
  <div id="log"></div>
  <div id="attbar"></div>
  <form id="f">
    <button type="button" id="att" title="attach image">&#128247;</button>
    <input id="attfile" type="file" accept="image/*" multiple hidden>
    <textarea id="inp" rows="2"
      placeholder="Send a message… (Enter to send, Shift+Enter for newline)"></textarea>
    <button type="submit" id="send" class="primary">send</button>
    <button type="button" id="stop">stop</button>
  </form>
</main>

<dialog id="settings">
  <h2>Settings</h2>
  <label style="display:block">system prompt
    <textarea id="s_system" rows="3"></textarea></label>
  <div class="cols">
    <label>temperature <input id="s_temp" type="number" step="0.05" value="0.8"></label>
    <label>max tokens <input id="s_maxtok" type="number" value="512"></label>
    <label>top_k <input id="s_topk" type="number" value="40"></label>
    <label>top_p <input id="s_topp" type="number" step="0.05" value="0.95"></label>
    <label>min_p <input id="s_minp" type="number" step="0.01" value="0.05"></label>
    <label>repeat penalty <input id="s_rep" type="number" step="0.05" value="1.0"></label>
    <label>presence penalty <input id="s_pres" type="number" step="0.1" value="0"></label>
    <label>frequency penalty <input id="s_freq" type="number" step="0.1" value="0"></label>
  </div>
  <label style="display:block">custom JSON (merged into the request)
    <input id="s_custom" type="text" placeholder='{"grammar": "..."}'></label>
  <footer>
    <button id="s_reset">reset</button>
    <button id="s_close" class="primary">close</button>
  </footer>
</dialog>

<script>
'use strict';
const $ = id => document.getElementById(id);
const log = $('log'), inp = $('inp');

/* ---------- settings ---------- */
const DEFS = { system: '', temp: 0.8, maxtok: 512, topk: 40, topp: 0.95,
               minp: 0.05, rep: 1.0, pres: 0, freq: 0, custom: '' };
let S = Object.assign({}, DEFS, JSON.parse(localStorage.lcg_settings || '{}'));
const SIDS = { system: 's_system', temp: 's_temp', maxtok: 's_maxtok',
  topk: 's_topk', topp: 's_topp', minp: 's_minp', rep: 's_rep',
  pres: 's_pres', freq: 's_freq', custom: 's_custom' };
function loadSettingsUI() { for (const k in SIDS) $(SIDS[k]).value = S[k]; }
function saveSettingsUI() {
  for (const k in SIDS) {
    const v = $(SIDS[k]).value;
    S[k] = (typeof DEFS[k] === 'number') ? parseFloat(v) : v;
  }
  localStorage.lcg_settings = JSON.stringify(S);
}
$('cfg').onclick = () => { loadSettingsUI(); $('settings').showModal(); };
$('s_close').onclick = () => { saveSettingsUI(); $('settings').close(); };
$('s_reset').onclick = () => { S = Object.assign({}, DEFS); loadSettingsUI(); };

/* ---------- conversations ---------- */
let convs = JSON.parse(localStorage.lcg_convs || '[]');   // [{id,title,messages}]
let curId = localStorage.lcg_cur || null;
function persist() {
  localStorage.lcg_convs = JSON.stringify(convs);
  localStorage.lcg_cur = curId || '';
}
function cur() { return convs.find(c => c.id === curId); }
function newConv() {
  const c = { id: Date.now().toString(36), title: 'New chat', messages: [] };
  convs.unshift(c); curId = c.id; persist(); renderConvs(); renderLog();
}
function renderConvs() {
  const el = $('convs'); el.innerHTML = '';
  for (const c of convs) {
    const d = document.createElement('div');
    d.className = 'conv' + (c.id === curId ? ' cur' : '');
    const s = document.createElement('span');
    s.textContent = c.title; s.title = c.title;
    s.ondblclick = () => { const t = prompt('rename', c.title);
      if (t) { c.title = t; persist(); renderConvs(); } };
    const del = document.createElement('button');
    del.textContent = '×'; del.title = 'delete';
    del.onclick = ev => { ev.stopPropagation();
      convs = convs.filter(x => x.id !== c.id);
      if (curId === c.id) curId = convs.length ? convs[0].id : null;
      persist(); renderConvs(); renderLog(); };
    d.onclick = () => { curId = c.id; persist(); renderConvs(); renderLog(); };
    d.append(s, del); el.appendChild(d);
  }
}
$('newc').onclick = newConv;
$('burger').onclick = () => $('side').classList.toggle('hide');
$('exp').onclick = () => {
  const a = document.createElement('a');
  a.href = URL.createObjectURL(new Blob([JSON.stringify(convs, null, 1)],
      { type: 'application/json' }));
  a.download = 'llamacog-conversations.json'; a.click();
};
$('imp').onclick = () => $('impfile').click();
$('impfile').onchange = async () => {
  const f = $('impfile').files[0]; if (!f) return;
  try { const got = JSON.parse(await f.text());
    if (Array.isArray(got)) { convs = got.concat(convs); persist(); renderConvs(); }
  } catch (e) { alert('bad JSON: ' + e); }
};

/* ---------- markdown ---------- */
function esc(t) { return t.replace(/&/g, '&amp;').replace(/</g, '&lt;')
                          .replace(/>/g, '&gt;'); }
function inline(t) {
  return t
    .replace(/`([^`]+)`/g, (m, c) => '<code>' + c + '</code>')
    .replace(/\*\*([^*]+)\*\*/g, '<b>$1</b>')
    .replace(/(^|[^*])\*([^*\n]+)\*/g, '$1<i>$2</i>')
    .replace(/\[([^\]]+)\]\((https?:[^)\s]+)\)/g,
             '<a href="$2" target="_blank" rel="noopener">$1</a>');
}
function mdToHtml(src) {
  const out = []; const lines = src.split('\n');
  let i = 0, list = null, quote = false;
  const closeList = () => { if (list) { out.push('</' + list + '>'); list = null; } };
  const closeQuote = () => { if (quote) { out.push('</blockquote>'); quote = false; } };
  while (i < lines.length) {
    let ln = lines[i];
    const fence = ln.match(/^```(\w*)\s*$/);
    if (fence) {
      closeList(); closeQuote();
      const buf = []; i++;
      while (i < lines.length && !/^```\s*$/.test(lines[i])) buf.push(lines[i++]);
      i++;
      out.push('<pre><button class="cp">copy</button><code class="lang-' +
               esc(fence[1]) + '">' + esc(buf.join('\n')) + '</code></pre>');
      continue;
    }
    ln = esc(ln);
    const h = ln.match(/^(#{1,4})\s+(.*)$/);
    if (h) { closeList(); closeQuote();
      out.push('<h' + (h[1].length + 1) + '>' + inline(h[2]) +
               '</h' + (h[1].length + 1) + '>'); i++; continue; }
    if (/^(-{3,}|\*{3,})\s*$/.test(ln)) { closeList(); closeQuote();
      out.push('<hr>'); i++; continue; }
    const q = ln.match(/^&gt;\s?(.*)$/);
    if (q) { closeList();
      if (!quote) { out.push('<blockquote>'); quote = true; }
      out.push(inline(q[1]) + '<br>'); i++; continue; }
    closeQuote();
    const ul = ln.match(/^\s*[-*+]\s+(.*)$/);
    const ol = ln.match(/^\s*\d+[.)]\s+(.*)$/);
    if (ul || ol) {
      const want = ul ? 'ul' : 'ol';
      if (list !== want) { closeList(); out.push('<' + want + '>'); list = want; }
      out.push('<li>' + inline((ul || ol)[1]) + '</li>'); i++; continue;
    }
    closeList();
    if (/^\|.*\|\s*$/.test(ln) && i + 1 < lines.length &&
        /^\|[\s:|-]+\|\s*$/.test(esc(lines[i + 1]))) {
      const cells = r => r.replace(/^\||\|\s*$/g, '').split('|');
      out.push('<table><tr>' + cells(ln).map(c =>
        '<th>' + inline(c.trim()) + '</th>').join('') + '</tr>');
      i += 2;
      while (i < lines.length && /^\|.*\|\s*$/.test(lines[i])) {
        out.push('<tr>' + cells(esc(lines[i])).map(c =>
          '<td>' + inline(c.trim()) + '</td>').join('') + '</tr>');
        i++;
      }
      out.push('</table>'); continue;
    }
    if (ln.trim() === '') { out.push(''); i++; continue; }
    out.push('<p>' + inline(ln) + '</p>'); i++;
  }
  closeList(); closeQuote();
  return out.join('\n');
}

/* ---------- rendering ---------- */
function msgText(m) {
  return typeof m.content === 'string' ? m.content
    : m.content.filter(p => p.type === 'text').map(p => p.text).join('');
}
function msgImages(m) {
  return typeof m.content === 'string' ? []
    : m.content.filter(p => p.type === 'image_url').map(p => p.image_url.url);
}
function renderMsg(m, idx) {
  const row = document.createElement('div');
  row.className = 'row ' + m.role;
  const d = document.createElement('div');
  d.className = 'msg';
  if (m.role === 'assistant') d.innerHTML = mdToHtml(msgText(m));
  else {
    d.textContent = msgText(m);
    for (const u of msgImages(m)) {
      const im = document.createElement('img');
      im.src = u; im.className = 'att'; d.appendChild(im);
    }
  }
  const acts = document.createElement('div');
  acts.className = 'acts';
  const copy = document.createElement('button');
  copy.textContent = 'copy';
  copy.onclick = () => navigator.clipboard.writeText(msgText(m));
  acts.appendChild(copy);
  const c = cur();
  if (c && idx === c.messages.length - 1 && m.role === 'assistant') {
    const rg = document.createElement('button');
    rg.textContent = 'regenerate';
    rg.onclick = regenerate;
    acts.appendChild(rg);
  }
  if (c && m.role === 'user' && idx === c.messages.length - 1) {
    const ed = document.createElement('button');
    ed.textContent = 'edit';
    ed.onclick = () => { inp.value = msgText(m);
      c.messages.splice(idx); persist(); renderLog(); inp.focus(); };
    acts.appendChild(ed);
  }
  if (m.stats) {
    const st = document.createElement('span');
    st.className = 'stats'; st.textContent = m.stats;
    acts.appendChild(st);
  }
  row.append(d, acts);
  return row;
}
function renderLog() {
  log.innerHTML = '';
  const c = cur();
  if (c) c.messages.forEach((m, i) => log.appendChild(renderMsg(m, i)));
  log.scrollTop = log.scrollHeight;
}
log.addEventListener('click', e => {
  if (e.target.classList && e.target.classList.contains('cp')) {
    const code = e.target.parentElement.querySelector('code');
    navigator.clipboard.writeText(code.textContent);
    e.target.textContent = 'copied';
    setTimeout(() => { e.target.textContent = 'copy'; }, 1200);
  }
});

/* ---------- attachments ---------- */
let pendingImages = [];
$('att').onclick = () => $('attfile').click();
$('attfile').onchange = async () => {
  for (const f of $('attfile').files) {
    const url = await new Promise(res => {
      const r = new FileReader(); r.onload = () => res(r.result);
      r.readAsDataURL(f);
    });
    pendingImages.push(url);
  }
  $('attfile').value = '';
  renderAttBar();
};
function renderAttBar() {
  const b = $('attbar'); b.innerHTML = '';
  pendingImages.forEach((u, i) => {
    const im = document.createElement('img');
    im.src = u; im.title = 'click to remove';
    im.onclick = () => { pendingImages.splice(i, 1); renderAttBar(); };
    b.appendChild(im);
  });
}

/* ---------- generation ---------- */
let aborter = null;
function apiMessages(c) {
  const ms = [];
  if (S.system.trim()) ms.push({ role: 'system', content: S.system });
  for (const m of c.messages)
    ms.push({ role: m.role, content: m.content });
  return ms;
}
async function generate() {
  const c = cur(); if (!c) return;
  const m = { role: 'assistant', content: '' };
  c.messages.push(m); persist(); renderLog();
  const row = log.lastChild, d = row.querySelector('.msg');
  $('send').style.display = 'none'; $('stop').style.display = '';
  aborter = new AbortController();
  const t0 = performance.now();
  let ntok = 0;
  const body = {
    messages: apiMessages(c).slice(0, -1), stream: true,
    temperature: S.temp, max_tokens: S.maxtok, top_k: S.topk,
    top_p: S.topp, min_p: S.minp, repeat_penalty: S.rep,
    presence_penalty: S.pres, frequency_penalty: S.freq,
  };
  if (S.custom.trim()) {
    try { Object.assign(body, JSON.parse(S.custom)); } catch (e) {}
  }
  try {
    const res = await fetch('/v1/chat/completions', {
      method: 'POST', headers: { 'Content-Type': 'application/json' },
      body: JSON.stringify(body), signal: aborter.signal,
    });
    if (!res.ok) throw new Error(await res.text());
    const rd = res.body.getReader();
    const dec = new TextDecoder();
    let buf = '';
    for (;;) {
      const { done, value } = await rd.read();
      if (done) break;
      buf += dec.decode(value, { stream: true });
      let i;
      while ((i = buf.indexOf('\n\n')) >= 0) {
        const line = buf.slice(0, i).trim();
        buf = buf.slice(i + 2);
        if (!line.startsWith('data: ')) continue;
        const payload = line.slice(6);
        if (payload === '[DONE]') continue;
        const js = JSON.parse(payload);
        const delta = js.choices && js.choices[0].delta &&
                      js.choices[0].delta.content;
        if (delta) {
          m.content += delta; ntok++;
          d.innerHTML = mdToHtml(m.content);
          log.scrollTop = log.scrollHeight;
        }
      }
    }
  } catch (err) {
    if (err.name !== 'AbortError') m.content += '\n[error: ' + err + ']';
  }
  const dt = (performance.now() - t0) / 1000;
  m.stats = ntok + ' chunks · ' + (ntok / dt).toFixed(1) + '/s';
  aborter = null;
  $('send').style.display = ''; $('stop').style.display = 'none';
  persist(); renderLog(); inp.focus();
}
function regenerate() {
  const c = cur(); if (!c || aborter) return;
  while (c.messages.length &&
         c.messages[c.messages.length - 1].role === 'assistant')
    c.messages.pop();
  persist(); generate();
}
$('stop').onclick = () => { if (aborter) aborter.abort(); };

$('f').addEventListener('submit', e => {
  e.preventDefault();
  if (aborter) return;
  const text = inp.value.trim();
  if (!text && !pendingImages.length) return;
  if (!cur()) newConv();
  const c = cur();
  let content = text;
  if (pendingImages.length) {
    content = pendingImages.map(u => ({ type: 'image_url', image_url: { url: u } }));
    content.push({ type: 'text', text });
    pendingImages = []; renderAttBar();
  }
  c.messages.push({ role: 'user', content });
  if (c.messages.length === 1)
    c.title = text.slice(0, 48) || 'image';
  inp.value = '';
  persist(); renderConvs();
  generate();
});
inp.addEventListener('keydown', e => {
  if (e.key === 'Enter' && !e.shiftKey) { e.preventDefault();
    $('f').requestSubmit(); }
});

/* ---------- boot ---------- */
fetch('/props').then(r => r.json()).then(p => {
  $('model').textContent = (p.model || '') + ' · ctx ' + p.n_ctx;
}).catch(() => {});
if (!convs.length) newConv();
else { if (!cur()) curId = convs[0].id; renderConvs(); renderLog(); }
</script>
</body>
</html>
"""
