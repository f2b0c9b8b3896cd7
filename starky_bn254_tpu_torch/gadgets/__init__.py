"""AIR building blocks: limb algebra, modular reduction, range checks,
lookups."""
