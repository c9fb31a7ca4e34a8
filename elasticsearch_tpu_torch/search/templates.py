"""Search templates: mustache-style parameter substitution.

Counterpart of `elasticsearch_tpu/search/templates.py` (the Mustache
subset of the `template` query): {{var}} substitution (interpolated, or
the param's own value when the placeholder is the whole string),
{{#toJson}}var{{/toJson}}, and {{#section}}...{{/section}} /
{{^section}}...{{/section}} over truthy params. The `_search/template`
endpoint is not ported yet.
"""

from __future__ import annotations

import json
import re

_VAR_RE = re.compile(r"\{\{([^{}#/^]+?)\}\}")
_TOJSON_RE = re.compile(r"\{\{#toJson\}\}\s*(.+?)\s*\{\{/toJson\}\}")
_SECTION_RE = re.compile(r"\{\{([#^])([^{}]+?)\}\}(.*?)\{\{/\2\}\}", re.S)


def _lookup(params: dict, path: str):
    cur = params
    for part in path.strip().split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur


def render_string(template: str, params: dict) -> str:
    """Render a template string to a string (values JSON-encoded when not
    plain scalars)."""

    def do_sections(text: str) -> str:
        def sub(m: re.Match) -> str:
            kind, name, body = m.group(1), m.group(2), m.group(3)
            val = _lookup(params, name)
            truthy = bool(val) and val not in (0, "")
            if kind == "^":
                return do_sections(body) if not truthy else ""
            if not truthy:
                return ""
            if isinstance(val, list):
                return "".join(do_sections(_VAR_RE.sub(
                    lambda mm: _fmt(item if mm.group(1).strip() == "."
                                    else _lookup(params, mm.group(1))), body))
                    for item in val)
            return do_sections(body)
        return _SECTION_RE.sub(sub, text)

    def _fmt(v) -> str:
        if v is None:
            return ""
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            # JSON-escape embedded quotes/backslashes — mustache in the
            # reference escapes for the JSON context
            # (JsonEscapingMustacheFactory)
            return json.dumps(v)[1:-1]
        if isinstance(v, (int, float)):
            return str(v)
        return json.dumps(v)

    text = _TOJSON_RE.sub(lambda m: json.dumps(_lookup(params, m.group(1))),
                          template)
    text = do_sections(text)
    return _VAR_RE.sub(lambda m: _fmt(_lookup(params, m.group(1))), text)


def render_template(template, params: dict):
    """Render a template (dict | JSON string) into a parsed JSON value.

    Dict form: placeholders inside string values are substituted; a string
    value that is exactly "{{var}}" is replaced by the param's native
    value (so sizes stay ints and arrays stay arrays).
    """
    params = params or {}
    if isinstance(template, str):
        rendered = render_string(template, params)
        return json.loads(rendered)

    def walk(node):
        if isinstance(node, dict):
            # keys can carry placeholders too ("match_{{template}}")
            return {(render_string(k, params) if "{{" in k else k): walk(v)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str):
            m = _VAR_RE.fullmatch(node)
            if m:
                val = _lookup(params, m.group(1))
                return val if val is not None else node
            return render_string(node, params)
        return node

    return walk(template)
