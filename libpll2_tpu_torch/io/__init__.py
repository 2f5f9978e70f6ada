from . import maps
