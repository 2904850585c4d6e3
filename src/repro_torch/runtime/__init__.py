"""Runtime settings of the port: the performance flags (:mod:`.flags`)."""
