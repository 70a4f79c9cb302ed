# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tikv_pd.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import tikv_meta_pb2 as tikv__meta__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rtikv_pd.proto\x12\x04pdpb\x1a\x0ftikv_meta.proto\"6\n\rRequestHeader\x12\x12\n\ncluster_id\x18\x01 \x01(\x04\x12\x11\n\tsender_id\x18\x02 \x01(\x04\"&\n\x05\x45rror\x12\x0c\n\x04type\x18\x01 \x01(\x05\x12\x0f\n\x07message\x18\x02 \x01(\t\"@\n\x0eResponseHeader\x12\x12\n\ncluster_id\x18\x01 \x01(\x04\x12\x1a\n\x05\x65rror\x18\x02 \x01(\x0b\x32\x0b.pdpb.Error\"Q\n\x06Member\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tmember_id\x18\x02 \x01(\x04\x12\x11\n\tpeer_urls\x18\x03 \x03(\t\x12\x13\n\x0b\x63lient_urls\x18\x04 \x03(\t\"8\n\x11GetMembersRequest\x12#\n\x06header\x18\x01 \x01(\x0b\x32\x13.pdpb.RequestHeader\"\x9a\x01\n\x12GetMembersResponse\x12$\n\x06header\x18\x01 \x01(\x0b\x32\x14.pdpb.ResponseHeader\x12\x1d\n\x07members\x18\x02 \x03(\x0b\x32\x0c.pdpb.Member\x12\x1c\n\x06leader\x18\x03 \x01(\x0b\x32\x0c.pdpb.Member\x12!\n\x0b\x65tcd_leader\x18\x04 \x01(\x0b\x32\x0c.pdpb.Member\"a\n\x10GetRegionRequest\x12#\n\x06header\x18\x01 \x01(\x0b\x32\x13.pdpb.RequestHeader\x12\x12\n\nregion_key\x18\x02 \x01(\x0c\x12\x14\n\x0cneed_buckets\x18\x03 \x01(\x08\"w\n\x11GetRegionResponse\x12$\n\x06header\x18\x01 \x01(\x0b\x32\x14.pdpb.ResponseHeader\x12\x1e\n\x06region\x18\x02 \x01(\x0b\x32\x0e.metapb.Region\x12\x1c\n\x06leader\x18\x03 \x01(\x0b\x32\x0c.metapb.Peer\"H\n\x0fGetStoreRequest\x12#\n\x06header\x18\x01 \x01(\x0b\x32\x13.pdpb.RequestHeader\x12\x10\n\x08store_id\x18\x02 \x01(\x04\"V\n\x10GetStoreResponse\x12$\n\x06header\x18\x01 \x01(\x0b\x32\x14.pdpb.ResponseHeader\x12\x1c\n\x05store\x18\x02 \x01(\x0b\x32\r.metapb.Store2\xc4\x01\n\x02PD\x12\x41\n\nGetMembers\x12\x17.pdpb.GetMembersRequest\x1a\x18.pdpb.GetMembersResponse\"\x00\x12>\n\tGetRegion\x12\x16.pdpb.GetRegionRequest\x1a\x17.pdpb.GetRegionResponse\"\x00\x12;\n\x08GetStore\x12\x15.pdpb.GetStoreRequest\x1a\x16.pdpb.GetStoreResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tikv_pd_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REQUESTHEADER._serialized_start=40
  _REQUESTHEADER._serialized_end=94
  _ERROR._serialized_start=96
  _ERROR._serialized_end=134
  _RESPONSEHEADER._serialized_start=136
  _RESPONSEHEADER._serialized_end=200
  _MEMBER._serialized_start=202
  _MEMBER._serialized_end=283
  _GETMEMBERSREQUEST._serialized_start=285
  _GETMEMBERSREQUEST._serialized_end=341
  _GETMEMBERSRESPONSE._serialized_start=344
  _GETMEMBERSRESPONSE._serialized_end=498
  _GETREGIONREQUEST._serialized_start=500
  _GETREGIONREQUEST._serialized_end=597
  _GETREGIONRESPONSE._serialized_start=599
  _GETREGIONRESPONSE._serialized_end=718
  _GETSTOREREQUEST._serialized_start=720
  _GETSTOREREQUEST._serialized_end=792
  _GETSTORERESPONSE._serialized_start=794
  _GETSTORERESPONSE._serialized_end=880
  _PD._serialized_start=883
  _PD._serialized_end=1079
# @@protoc_insertion_point(module_scope)
