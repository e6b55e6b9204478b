"""L1/L6 — reference-format TSV readers and output writers."""
