"""Plain float32 references of the configurations' models, one module a
family, named by a configuration file's `reference` key."""
