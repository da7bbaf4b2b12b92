"""One module a system under test, named by a configuration's ``system``."""
