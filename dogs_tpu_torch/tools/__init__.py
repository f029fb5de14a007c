"""Command-line tools of the port: a written COLMAP scene, the .ksplat converter, the
Mega-NeRF and MatrixCity converters, and the segment-sum A/B on the card."""
