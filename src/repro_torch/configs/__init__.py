"""Architecture configurations: a copy of the reference's ``repro.configs``
(the ten ``--arch`` modules, data only, and their registry)."""
