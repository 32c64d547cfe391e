"""The benchmark of hybridrenderer_tpu_torch: ``run.py`` runs one cell
(a configuration under a traffic mix, named in BENCHMARK.json at the
root of the checkout) once on the card and prints one JSON result line.
"""
