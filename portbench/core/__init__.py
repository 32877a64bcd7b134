"""The harness's general machinery: what no single cell owns."""
