"""The port's systems layer: the HTS scheduler (:mod:`.hts`)."""
