"""The plain references the check compares the program with: a render
path's frame worked out again from the benchmark's own arrays, in plain
PyTorch, with a rasterizer, a tree and ray queries of their own. Each
path has a module named after it (spec.reference): hybrid.py, which is
render.py's frame, and forward.py. They load nothing of the program."""
