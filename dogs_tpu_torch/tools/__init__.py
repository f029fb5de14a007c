"""Command-line tools of the port: a written COLMAP scene, the .ksplat converter, and the
Mega-NeRF and MatrixCity converters."""
