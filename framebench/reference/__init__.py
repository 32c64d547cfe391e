"""The plain reference the check compares the program with: the hybrid
path's frame worked out again from the benchmark's own arrays, in plain
PyTorch, with a rasterizer, a tree and ray queries of its own. It loads
nothing of the program (render.py)."""
