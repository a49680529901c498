"""Pre-built input and output connectors."""
