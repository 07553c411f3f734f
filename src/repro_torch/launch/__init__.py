"""launch — entry points (`serve`)."""
