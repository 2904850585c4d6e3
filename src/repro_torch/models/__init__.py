"""The model stack of the port: layers, the dense transformer, the model
registry and the weight carry from the reference (:mod:`.convert`)."""
