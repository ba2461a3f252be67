"""Host-side parsing of `.c2v` path-context rows and the training reader;
the VarMisuse head's `.vm.c2v` reader and generator (vm_reader.py,
varmisuse_gen.py)."""
