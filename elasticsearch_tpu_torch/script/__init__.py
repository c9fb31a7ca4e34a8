"""Scripting subsystem (ref: script/ScriptService.java).

Counterpart of `elasticsearch_tpu/script/`: `expression.py` holds the
language and its torch device backend, `service.py` the stored-script
registry, script-spec parsing and the doc accessors binding scripts to
segment columns on each backend.
"""

from .expression import (CompiledScript, compile_script, DocAccessor,
                         FieldHandle, TorchBackend, referenced_fields)
from .service import (ScriptService, parse_script_spec, SegmentDocAccessor,
                      ColumnDocAccessor, run_field_script)

__all__ = [
    "CompiledScript", "compile_script", "DocAccessor", "FieldHandle",
    "TorchBackend",
    "referenced_fields", "ScriptService", "parse_script_spec",
    "SegmentDocAccessor", "ColumnDocAccessor", "run_field_script",
]
