"""Model: cfg parser, graph IR, layers, decode and the network walk."""
