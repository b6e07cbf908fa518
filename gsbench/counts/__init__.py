"""The benchmark's own counts: the least bytes and operations of each
kernel launch, and a GNN step's model flops, from a plan's true rows and
edges (never its padded shapes). ``peaks`` holds the card's published
rates; ``step`` summarises a plan and lists the launches one step makes."""
