"""parallel subpackage: the device mesh and the keyed exchange."""
