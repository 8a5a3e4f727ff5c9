from .ops import gather_pages, scatter_pages
from .ref import page_gather_ref, page_scatter_ref
