from .entry import Attr, Entry
from .filer import Filer
from .filerstore import FilerStore, get_store, register_store

__all__ = ["Attr", "Entry", "Filer", "FilerStore", "get_store", "register_store"]
