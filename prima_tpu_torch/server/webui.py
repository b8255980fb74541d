"""Built-in chat web UI served at / (the reference server's static
index.html analogue, examples/server/public/). One self-contained page:
streams /v1/chat/completions over SSE, no external assets."""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>prima-tpu server</title>
<style>
  :root { color-scheme: light dark; }
  body { font-family: system-ui, sans-serif; max-width: 46rem;
         margin: 2rem auto; padding: 0 1rem; }
  #log { white-space: pre-wrap; border: 1px solid #8884; border-radius: 8px;
         padding: 1rem; min-height: 14rem; }
  .u { font-weight: 600; }
  .a { margin-bottom: .75rem; display: block; }
  form { display: flex; gap: .5rem; margin-top: 1rem; }
  input[type=text] { flex: 1; padding: .5rem; border-radius: 6px;
                     border: 1px solid #8886; }
  button { padding: .5rem 1rem; border-radius: 6px; border: 0;
           background: #4a6fa5; color: white; cursor: pointer; }
  small { opacity: .6 }
</style>
</head>
<body>
<h2>prima-tpu</h2>
<small id="props"></small>
<div id="log"></div>
<form id="f">
  <input type="text" id="q" placeholder="Say something..." autofocus>
  <button>Send</button>
</form>
<script>
const log = document.getElementById('log');
const msgs = [];
fetch('/props').then(r => r.json()).then(p => {
  document.getElementById('props').textContent =
    `${p.model} · ${p.arch} · n_ctx ${p.n_ctx} · ${p.total_slots} slots`;
});
document.getElementById('f').addEventListener('submit', async (e) => {
  e.preventDefault();
  const q = document.getElementById('q');
  const text = q.value.trim();
  if (!text) return;
  q.value = '';
  msgs.push({role: 'user', content: text});
  log.append(Object.assign(document.createElement('span'),
                           {className: 'u', textContent: text + '\\n'}));
  const out = Object.assign(document.createElement('span'), {className: 'a'});
  log.append(out);
  const res = await fetch('/v1/chat/completions', {
    method: 'POST', headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({messages: msgs, stream: true}),
  });
  const reader = res.body.getReader();
  const dec = new TextDecoder();
  let buf = '', reply = '';
  for (;;) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    for (;;) {
      const i = buf.indexOf('\\n\\n');
      if (i < 0) break;
      const line = buf.slice(0, i).trim();
      buf = buf.slice(i + 2);
      if (!line.startsWith('data: ')) continue;
      const data = line.slice(6);
      if (data === '[DONE]') continue;
      const delta = JSON.parse(data).choices?.[0]?.delta?.content || '';
      reply += delta;
      out.textContent = reply + '\\n';
    }
  }
  msgs.push({role: 'assistant', content: reply});
});
</script>
</body>
</html>
"""
