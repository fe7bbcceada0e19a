"""Plain PyTorch references of the benchmark's configurations: one module
a model (named by the configuration's ``model``) and the training step they
share (``common.py``).  They import only torch and numpy."""
